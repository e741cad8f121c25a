"""Process meshes and block layouts of the distributed pencil engine.

Counterpart of ``offt_tpu/dist/mesh.py``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of an
initialised default process group, with dims ("row", "col") (or
("slice", "row", "col") for a multi-slice mesh). Collectives over "col"
are the phase-1 exchanges of the forward pipeline, over "row" the
phase-2 ones. A "cuda" mesh runs its collectives with NCCL, a "cpu" mesh
with gloo; :func:`make_mesh` refuses a default group whose backend does
not serve the mesh's device type, and nothing switches backend later.

The rank order decides which ranks share a row or column group (the
reference's ROTATE_RANKORDER): RANKORDER_ROW lays rank i at
(i // p2, i % p2), RANKORDER_COL at (i % p1, i // p1). RANKORDER_AUTO is
row-major: torch exposes no interconnect topology to place by.

Where JAX shards a global array, each rank here holds its block of it. A
:class:`Layout` says which mesh dims split which array dims, and
:meth:`Layout.block` gives a rank's block of a global shape by
ceil-division: every block has ceil(n / p) entries but the last ones,
which may be short or empty (the reference's padded static shards,
``plan/api.py:254-269``, seen from one rank).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist

ROW = "row"      # size p1: the forward pipeline's phase-2 group
COL = "col"      # size p2: the forward pipeline's phase-1 group
SLICE = "slice"  # multi-slice mesh: shards a leading batch dim only

RANKORDER_AUTO = 0  # row-major (no topology to place by)
RANKORDER_ROW = 1   # rank i -> (i // p2, i % p2)
RANKORDER_COL = 2   # rank i -> (i % p1, i // p1)

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def _grid_ranks(ranks, p1: int, p2: int, rankorder: int) -> np.ndarray:
    """Lay the first ``p1*p2`` ranks onto the (ROW, COL) grid per
    ``rankorder`` (the reference's ``_grid_devices`` on ranks)."""
    ranks = list(ranks)[: p1 * p2]
    if rankorder in (RANKORDER_AUTO, RANKORDER_ROW):
        return np.asarray(ranks).reshape(p1, p2)
    if rankorder == RANKORDER_COL:
        return np.asarray(ranks).reshape(p2, p1).T
    raise ValueError(f"rankorder must be 0|1|2, got {rankorder}")


def _world(device_type: str) -> int:
    """The default group's size, after checking that it exists and that
    its backend serves ``device_type``."""
    if device_type not in _BACKEND:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a mesh needs an initialised default process "
                           "group: call torch.distributed."
                           "init_process_group first")
    backend = str(dist.get_backend())
    if _BACKEND[device_type] not in backend:
        raise ValueError(f"a {device_type!r} mesh runs its collectives with "
                         f"{_BACKEND[device_type]}, the default group's "
                         f"backend is {backend!r}")
    return dist.get_world_size()


def quiesce() -> None:
    """Wait until every rank of the default world is done with its
    collectives, before the world is destroyed: a barrier (every rank's
    collectives returned), then the same through the rendezvous store of
    a ``torchrun`` world (every rank's barrier returned, so no message of
    the world is in flight), so that no rank tears its connections down
    while another still reads the tail of the last collective. Without it,
    on a loaded 8-core host (twelve 4-rank gloo worlds at once,
    ``python tests/torch_examples.py dist1d_signal 12 48``) about one run
    of ``examples_torch/dist1d_signal.py`` in 25 had a rank abort at
    teardown ("terminate called without an active exception") after its
    work was done; with the barrier alone, about one in 150. Call it on
    the success path only: after an error a rank exits at once and
    ``torchrun`` stops the others."""
    import datetime
    import os

    if not dist.is_initialized():
        return
    dist.barrier()
    world = dist.get_world_size()
    if world > 1 and "MASTER_PORT" in os.environ:
        store = dist.PrefixStore(
            "quiesce/" + os.environ.get("TORCHELASTIC_RUN_ID", ""),
            dist.TCPStore(os.environ["MASTER_ADDR"],
                          int(os.environ["MASTER_PORT"]), is_master=False,
                          timeout=datetime.timedelta(minutes=5)))
        store.set(str(dist.get_rank()), "done")
        store.wait([str(r) for r in range(world)])


def _device_mesh(device_type: str, grid: np.ndarray, names: tuple):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(device_type, torch.as_tensor(grid, dtype=torch.int64),
                      mesh_dim_names=names)


def make_mesh(p1: int, p2: int | None = None, device_type: str = "cuda",
              rankorder: int = RANKORDER_AUTO):
    """A (p1, p2) mesh with dims ("row", "col") over the default group's
    ranks. With ``p2=None`` it uses every rank: p2 = world // p1. A
    collective call: every rank of the default group makes it."""
    n = _world(device_type)
    if p2 is None:
        if n % p1 != 0:
            raise ValueError(f"p1={p1} does not divide world size {n}")
        p2 = n // p1
    if p1 * p2 > n:
        raise ValueError(f"mesh {p1}x{p2} needs {p1 * p2} ranks, have {n}")
    return _device_mesh(device_type, _grid_ranks(range(n), p1, p2, rankorder),
                        (ROW, COL))


_REGRIDDED: dict = {}


def with_rankorder(mesh, rankorder: int):
    """The (ROW, COL) mesh's ranks re-gridded per ``rankorder`` from their
    sorted order. RANKORDER_AUTO, and any order that gives the same grid,
    returns ``mesh`` itself; a new grid is built once per (default group,
    mesh, order) and kept, so the groups are not made again (a
    collective call)."""
    if rankorder == RANKORDER_AUTO:
        return mesh
    if SLICE in mesh.mesh_dim_names:
        raise ValueError("rankorder re-gridding applies to (row, col) "
                         "meshes only, not multi-slice meshes")
    p1, p2 = mesh_shape(mesh)
    grid = _grid_ranks(sorted(mesh.mesh.flatten().tolist()), p1, p2,
                       rankorder)
    if np.array_equal(grid, mesh.mesh.numpy()):
        return mesh
    key = (id(dist.group.WORLD), mesh.device_type,
           tuple(mesh.mesh.flatten().tolist()),
           tuple(grid.flatten().tolist()))
    if key not in _REGRIDDED:
        _REGRIDDED[key] = _device_mesh(mesh.device_type, grid,
                                       mesh.mesh_dim_names)
    return _REGRIDDED[key]


def make_multislice_mesh(slices: int, p1: int, p2: int | None = None,
                         device_type: str = "cuda"):
    """A (slices, p1, p2) mesh with dims ("slice", "row", "col"): each
    slice is a contiguous block of ranks with its own row and column
    groups. The pencil exchanges run over row and col only, within a
    slice; the slice dim shards a leading batch dim."""
    n = _world(device_type)
    if p2 is None:
        if p1 <= 0 or (n // slices) % p1 != 0:
            raise ValueError(f"p1={p1} does not divide the per-slice count "
                             f"{n // slices}")
        p2 = (n // slices) // p1
    if slices * p1 * p2 > n:
        raise ValueError(f"mesh {slices}x{p1}x{p2} needs "
                         f"{slices * p1 * p2} ranks, have {n}")
    grid = np.arange(slices * p1 * p2).reshape(slices, p1, p2)
    return _device_mesh(device_type, grid, (SLICE, ROW, COL))


def mesh_shape(mesh) -> tuple[int, int]:
    """(p1, p2): the sizes of the row and col dims."""
    names = mesh.mesh_dim_names
    return (mesh.mesh.shape[names.index(ROW)],
            mesh.mesh.shape[names.index(COL)])


def _sizes(mesh) -> tuple:
    """((name, size), ...) of a DeviceMesh, or of a {name: size} mapping."""
    if isinstance(mesh, dict):
        return tuple(mesh.items())
    return tuple(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _batch_spec(names, ndim: int) -> tuple:
    """Leading batch-dim entries: the slice dim shards the first batch
    dim on a multi-slice mesh, the other batch dims are whole."""
    nbatch = ndim - 3
    if SLICE in names:
        if nbatch < 1:
            raise ValueError(
                "a multi-slice mesh shards a leading batch axis over the "
                "slice dim: use batch_dims >= 1 (a pure spatial "
                "decomposition must not cross slices)")
        return (SLICE,) + (None,) * (nbatch - 1)
    return (None,) * nbatch


@dataclasses.dataclass(frozen=True)
class Layout:
    """How a global array lies on a mesh. ``dims`` has one entry per
    array dim: None (whole on every rank), a mesh dim name, or a tuple of
    names (split over their product, the first slowest). ``sizes`` is
    ((name, size), ...) of the mesh."""

    dims: tuple
    sizes: tuple

    def block(self, shape, coord: dict) -> tuple:
        """The slices of ``shape`` that the rank at mesh coordinate
        ``coord`` ({name: index}) holds, by ceil-division."""
        if len(shape) != len(self.dims):
            raise ValueError(f"shape {tuple(shape)} has {len(shape)} dims, "
                             f"the layout {len(self.dims)}")
        size = dict(self.sizes)
        out = []
        for n, entry in zip(shape, self.dims):
            if entry is None:
                out.append(slice(0, n))
                continue
            names = (entry,) if isinstance(entry, str) else entry
            i = 0
            for name in names:
                i = i * size[name] + coord[name]
            b = -(-n // math.prod(size[name] for name in names))
            lo = min(i * b, n)
            out.append(slice(lo, min(lo + b, n)))
        return tuple(out)

    def local_shape(self, shape, coord: dict) -> tuple:
        return tuple(s.stop - s.start for s in self.block(shape, coord))


def input_layout(mesh, ndim: int = 3) -> Layout:
    """z-pencils: x over row, y over col, z whole; batch dims whole (the
    first over slice on a multi-slice mesh). ``mesh`` is a DeviceMesh or
    a {name: size} mapping."""
    sizes = _sizes(mesh)
    names = [s[0] for s in sizes]
    return Layout(_batch_spec(names, ndim) + (ROW, COL, None), sizes)


def output_layout(mesh, ndim: int = 3) -> Layout:
    """The transposed-out layout: x whole, y over row, z over col."""
    sizes = _sizes(mesh)
    names = [s[0] for s in sizes]
    return Layout(_batch_spec(names, ndim) + (None, ROW, COL), sizes)


def natural_layout(mesh, ndim: int = 3) -> Layout:
    """The distributed long-1-D engine's layout of (..., 1, 1, n) operands,
    in and out (the reference's ``natural_sharding``): the last dim in
    contiguous chunks over the linearised (row, col) order of ``mesh``,
    the first rank's chunk first (after ``with_rankorder``, the order of
    the re-gridded mesh that the plan keeps)."""
    return Layout((None,) * (ndim - 1) + ((ROW, COL),), _sizes(mesh))


def linear_index(mesh, rank: int | None = None) -> int:
    """``rank``'s place (default: this process) in the linearised (row,
    col) order of ``mesh``: row * p2 + col."""
    c = coords(mesh, rank)
    return c[ROW] * mesh_shape(mesh)[1] + c[COL]


def batch_layout(mesh, ndim: int) -> Layout:
    """``batch_sharded`` plans: the first dim over every rank of the
    (row, col) grid, the rest whole."""
    return Layout(((ROW, COL),) + (None,) * (ndim - 1), _sizes(mesh))


def coords(mesh, rank: int | None = None) -> dict:
    """{dim name: index} of ``rank`` (default: this process) in the mesh;
    raises when the rank is not in it."""
    rank = dist.get_rank() if rank is None else rank
    pos = (mesh.mesh == rank).nonzero()
    if len(pos) != 1:
        raise ValueError(f"rank {rank} is not in the mesh")
    return dict(zip(mesh.mesh_dim_names, pos[0].tolist()))


def local_block(mesh, layout: Layout, shape) -> tuple:
    """This rank's slices of a global ``shape`` laid out by ``layout``."""
    return layout.block(shape, coords(mesh))
