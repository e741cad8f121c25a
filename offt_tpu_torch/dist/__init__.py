"""Distribution: process meshes and block layouts (``mesh``) and the
pencil engine (``pencil``). The distributed long-1-D engine
(``offt_tpu/dist/long1d.py``) is ROADMAP Queue 1 item 4."""

from .mesh import (COL, RANKORDER_AUTO, RANKORDER_COL, RANKORDER_ROW, ROW,
                   SLICE, Layout, batch_layout, coords, input_layout,
                   local_block, make_mesh, make_multislice_mesh, mesh_shape,
                   output_layout, with_rankorder)

__all__ = ["COL", "Layout", "RANKORDER_AUTO", "RANKORDER_COL",
           "RANKORDER_ROW", "ROW", "SLICE", "batch_layout", "coords",
           "input_layout", "local_block", "make_mesh",
           "make_multislice_mesh", "mesh_shape", "output_layout",
           "with_rankorder"]
