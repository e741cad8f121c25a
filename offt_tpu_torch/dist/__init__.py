"""Distribution: process meshes and block layouts (``mesh``), the pencil
engine (``pencil``) and the distributed long-1-D engine (``long1d``)."""

from .long1d import dist1d_split
from .mesh import (COL, RANKORDER_AUTO, RANKORDER_COL, RANKORDER_ROW, ROW,
                   SLICE, Layout, batch_layout, coords, input_layout,
                   local_block, make_mesh, make_multislice_mesh, mesh_shape,
                   natural_layout, output_layout, quiesce, with_rankorder)

__all__ = ["COL", "Layout", "RANKORDER_AUTO", "RANKORDER_COL",
           "RANKORDER_ROW", "ROW", "SLICE", "batch_layout", "coords",
           "dist1d_split", "input_layout", "local_block", "make_mesh",
           "make_multislice_mesh", "mesh_shape", "natural_layout",
           "output_layout", "quiesce", "with_rankorder"]
