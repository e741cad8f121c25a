"""The planar c2c and packed r2c/c2r transforms, with their CUDA kernels.

Counterpart of these functions of ``offt_tpu/kernels/pallas_fft.py``:
``fft_last``, ``fft_sublane`` (with ``_sublane_nd``), ``fft_slab_yz``,
``fft_x_from_padded``, ``fft_1d_planar`` and ``fft3d_planar`` (c2c);
``rfft_slab_yz``, ``fft_x_to_padded``, ``irfft_slab_yz``,
``_assemble_mp1``, ``_plane0_split``, ``unpack_rfft3d``, ``pack_rfft3d``,
``rfft3d_planar`` and ``irfft3d_planar`` (r2c/c2r); ``rfft_last_planar``
(r2c along the last axis, the unfused real route and the distributed
packed forward); ``icrfft_last_planar`` (packed c2r along the last axis,
the distributed packed inverse); ``fft3d_cube`` (all three axes of
batched small cubes in one launch); and the gates
``can_use_pallas``, ``can_fuse_slab``, ``can_use_padded_x``,
``can_use_rfft3d``, ``can_use_rfft_last``, ``can_fuse_cube`` and
``bank_conflict_stride``,
which keep the reference's values so that both packages take the same
routes. The four-step kernels' wrappers live in :mod:`.fourstep` and use
the plumbing here.

Data is planar float32: a (re, im) pair of tensors of one shape (the
real side of r2c/c2r is one float32 tensor). Each kernel wrapper
dispatches on the tensors' device:

- CUDA: it launches its hand-written kernel (``csrc/``, built by
  :mod:`._build`) on the current stream, or raises;
- CPU: it runs its plain version, torch ops on the same f32 tables
  (stage products as ``torch.matmul``, twiddle multiplies, reshapes);
- meta: it only allocates its outputs, so a plan can learn its route and
  its tables without data.

Every wrapper counts its kernel launches (``fn.launches``) and its plain
calls (``fn.plain_calls``); :func:`reset_counts` zeroes them. Each
wrapper is listed by name in ``WRAPPERS`` as it is defined. The two
last-axis row kernels (``fft_last``, ``rfft_last_planar``) run the
register core of ``csrc/fft_regs.cuh`` on the lengths :func:`_reg_rows`
and :func:`_reg_core` admit, the strided-axis kernel (``fft_sublane``,
``_sublane_nd``, ``fft_x_from_padded``, ``fft_x_to_padded``) its column
variant on the lengths :func:`_reg_axis` admits, the three slab kernels
(``fft_slab_yz``, ``rfft_slab_yz``, ``irfft_slab_yz``) on the slabs
:func:`_reg_slab` and :func:`_reg_rslab` admit (rows and the column
variant: in one grid of clusters holding the slab in shared memory where
:func:`_cluster_slab` admits it, :func:`_cluster_irslab` for the c2r,
else in two grids), the cube kernel (``fft3d_cube``) its register cube
(``csrc/fft_cube_regs.cu``) on the cubes :func:`_reg_cube` admits, and
all of them the dense core of ``csrc/fft_core.cuh`` on the rest; of
their launches, ``fn.reg_launches`` took the register core. A launch is
one call of the kernel's C entry point.

``precision`` is accepted everywhere for parity with the reference and
ignored: every stage computes in f32 FMA on the card (the bf16 stacked
modes are TPU MXU emulations).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from . import tables as tb

DEFAULT_PRECISION = "highest"

# pad lanes per (x, y) row of the padded intermediate (pallas_fft.py:1476)
_STRIDE_PAD = 8
# the reference's VMEM-derived gates, kept so that routes match it
_SLAB_VMEM_LIMIT = 1 << 20
_VMEM_CAP = 120 << 20
_X_VMEM_BLOCKS = 16
_CUBE_MAX_ELEMS = 1 << 21    # 128^3 (pallas_fft.py:1114)

# shared-memory tile budget of one block (three per SM fit beside the
# roots), and the most a block may have on Hopper
_TILE_BYTES = 64 << 10
_SMEM_MAX = 232448
_THREADS = 256   # kThreads in csrc/fft_core.cuh

# kernel name -> CUDA source, the Pallas kernel it replaces, its wrappers
KERNELS = {
    "fft_last": {
        "source": "offt_tpu_torch/kernels/csrc/fft_last.cu",
        "replaces": "offt_tpu/kernels/pallas_fft.py:819",
        "wrappers": ("fft_last",),
    },
    "fft_axis": {
        "source": "offt_tpu_torch/kernels/csrc/fft_axis.cu",
        "replaces": "offt_tpu/kernels/pallas_fft.py:900,993,1509,1574",
        "wrappers": ("fft_sublane", "_sublane_nd", "fft_x_from_padded",
                     "fft_x_to_padded"),
    },
    "fft_slab": {
        "source": "offt_tpu_torch/kernels/csrc/fft_slab.cu",
        "replaces": "offt_tpu/kernels/pallas_fft.py:1404",
        "wrappers": ("fft_slab_yz",),
    },
    "rfft_slab": {
        "source": "offt_tpu_torch/kernels/csrc/rfft_slab.cu",
        "replaces": "offt_tpu/kernels/pallas_fft.py:1944",
        "wrappers": ("rfft_slab_yz",),
    },
    "irfft_slab": {
        "source": "offt_tpu_torch/kernels/csrc/irfft_slab.cu",
        "replaces": "offt_tpu/kernels/pallas_fft.py:2160",
        "wrappers": ("irfft_slab_yz",),
    },
    "assemble_mp1": {
        "source": "offt_tpu_torch/kernels/csrc/assemble_mp1.cu",
        "replaces": "offt_tpu/kernels/pallas_fft.py:2012",
        "wrappers": ("_assemble_mp1",),
    },
    "rfft_last": {
        "source": "offt_tpu_torch/kernels/csrc/rfft_last.cu",
        "replaces": "offt_tpu/kernels/pallas_fft.py:1685",
        "wrappers": ("rfft_last_planar",),
    },
    "icrfft_last": {
        "source": "offt_tpu_torch/kernels/csrc/icrfft_last.cu",
        "replaces": "offt_tpu/kernels/pallas_fft.py:2308",
        "wrappers": ("icrfft_last_planar",),
    },
    "step1_twiddle": {
        "source": "offt_tpu_torch/kernels/csrc/fourstep.cu",
        "replaces": "offt_tpu/kernels/fourstep.py:166",
        "wrappers": ("_step1_twiddle",),
    },
    "step3_transposed": {
        "source": "offt_tpu_torch/kernels/csrc/fourstep.cu",
        "replaces": "offt_tpu/kernels/fourstep.py:213",
        "wrappers": ("_step3_transposed",),
    },
    "fft_cube": {
        # the register cube; csrc/fft_cube.cu keeps the dense one
        "source": "offt_tpu_torch/kernels/csrc/fft_cube_regs.cu",
        "replaces": "offt_tpu/kernels/pallas_fft.py:1156",
        "wrappers": ("fft3d_cube",),
    },
}


# --------------------------------------------------------------------------
# gates (same values as the reference)
# --------------------------------------------------------------------------

def can_use_pallas(n: int, radices=None) -> bool:
    return tb._pick_stages(n, radices) is not None


def bank_conflict_stride(ny: int, nz: int) -> bool:
    """True when the f32 x-axis row stride is divisible by 2^16 bytes (a
    v5e HBM-channel finding, kept so that the routes match the
    reference; whether Hopper wants it is an open question)."""
    return (ny * nz * 4) % (1 << 16) == 0


def can_fuse_slab(ny: int, nz: int, rad_y=None, rad_z=None) -> bool:
    """The reference's slab gate. The CUDA slab kernel tiles the slab
    through shared memory and has no size limit of its own; the VMEM
    ceiling stays so that the route matches the reference."""
    return (ny * nz <= _SLAB_VMEM_LIMIT
            and tb._pick_stages(ny, rad_y) is not None
            and tb._pick_stages(nz, rad_z) is not None)


def can_use_padded_x(n: int, ny: int, nz: int, radices=None) -> bool:
    return (tb._pick_stages(n, radices) is not None
            and ny % 8 == 0 and nz % 128 == 0
            and _X_VMEM_BLOCKS * n * 8 * 128 * 4 <= _VMEM_CAP)


def can_use_rfft3d(nx: int, ny: int, nz: int, rad_x=None, rad_y=None,
                   rad_z=None) -> bool:
    """The reference's gate of the packed r2c/c2r path: M = Nz/2 a
    multiple of 128, Ny of 8, every axis 2-stage, the slab under the VMEM
    ceiling and the pitched x pass eligible. The CUDA kernels need none of
    it beyond an even Nz; the values stay so that routes match."""
    m = nz // 2
    return (nz % 2 == 0 and m % 128 == 0 and ny % 8 == 0
            and tb._pick_2stage(m, rad_z) is not None
            and tb._pick_2stage(ny, rad_y) is not None
            and tb._pick_2stage(nx, rad_x) is not None
            and ny * m <= _SLAB_VMEM_LIMIT
            and can_use_padded_x(nx, ny, m, rad_x))


def can_use_rfft_last(n: int, radices=None) -> bool:
    """The reference's gate of the r2c kernel along the last axis: an even
    N >= 4 whose half length is 2-stage (``_pick_2stage``)."""
    return n % 2 == 0 and n >= 4 and tb._pick_2stage(n // 2,
                                                    radices) is not None


def can_fuse_cube(nx: int, ny: int, nz: int, rad_x=None, rad_y=None,
                  rad_z=None, precision: str = DEFAULT_PRECISION) -> bool:
    """The reference's cube gate: at most 2^21 elements, Z a multiple of
    128, Y of 8, every axis expressible. ``precision`` is accepted for
    parity: the reference's stacked picks exist for exactly the lengths
    its unstacked ones do, so the gate's value does not depend on it
    (the picks themselves may differ; the values do not)."""
    return (nx * ny * nz <= _CUBE_MAX_ELEMS and nz % 128 == 0
            and ny % 8 == 0
            and tb._pick_stages(nx, rad_x) is not None
            and tb._pick_stages(ny, rad_y) is not None
            and tb._pick_stages(nz, rad_z) is not None)


def _pow2(n: int) -> bool:
    """A power of two in [16, 4096]: the register core's lengths."""
    return 16 <= n <= 4096 and n & (n - 1) == 0


def _reg_core(n: int) -> bool:
    """Whether ``rfft_last_planar`` and ``icrfft_last_planar`` at half
    length n, and each kernel of the four-step pair at its own length,
    launch the register core (``csrc/fft_regs.cuh``): a power of two in
    [16, 4096]. Every other length takes the dense core (their untangle,
    c2r and transposing rows have no mixed instances). The register core
    ignores the radices and the rows per block."""
    return _pow2(n)


# the mixed lengths R0 2^k (R0 = 3, 5; 16 <= 2^k <= 512) the register
# core's column variant has (csrc/fft_axis_mix.cu)
_MIX_LENGTHS = frozenset(r0 << k for r0 in (3, 5) for k in range(4, 10))
# the mixed lengths its rows have (csrc/fft_last_mix.cu): those and 3072
# (P = 256, one row a block), whose exchanges take one wavefront as rows
# and would take two as columns
_MIX_ROW_LENGTHS = _MIX_LENGTHS | {3072}


def _reg_values(n: int) -> int:
    """Complex values a thread of the register core holds at length n: 16
    at a power of two, 4 R0 at a mixed length R0 2^k (12 or 20); a line
    takes n / that many threads (P)."""
    return 4 * (3 if n % 3 == 0 else 5) if n in _MIX_ROW_LENGTHS else 16


def _reg_rows(n: int) -> bool:
    """Whether ``fft_last`` at length n, and the z rows of the c2c slab
    (``fft_slab_yz``), launch the register core's rows: a power of two in
    [16, 4096], or a mixed length of ``_MIX_ROW_LENGTHS`` (3 2^k in [48,
    1536] and 3072, 5 2^k in [80, 2560]: ``regs::rows_mix``, radix-4
    passes then one of radix 12 or 20, the exchange planes swizzled).
    Every other length takes the dense core."""
    return _pow2(n) or n in _MIX_ROW_LENGTHS


def _reg_slab(ny: int, nz: int) -> bool:
    """Whether the c2c slab kernel (``fft_slab_yz`` on (ny, nz)) launches
    the register core: z as rows (:func:`_reg_rows`), y on the column
    variant (:func:`_reg_axis`), each a power of two in [16, 4096] or a
    mixed length (the mixed ones in two grids). Every other slab takes
    the dense core. The register slab ignores the radices and the
    tiles."""
    return _reg_rows(nz) and _reg_axis(ny)


def _reg_rslab(ny: int, m: int) -> bool:
    """Whether the r2c and c2r slab kernels (``rfft_slab_yz``,
    ``irfft_slab_yz`` on (ny, M = N/2)) launch the register core: both
    powers of two in [16, 4096] (their r2c and c2r rows have no mixed
    instances). Every other slab takes the dense core."""
    return _pow2(ny) and _pow2(m)


def _reg_axis(n: int) -> bool:
    """Whether the strided-axis kernel (``fft_sublane``, ``_sublane_nd``,
    ``fft_x_from_padded``, ``fft_x_to_padded`` at transform length n)
    launches the register core's column variant: a power of two in
    [16, 4096], or a mixed length of ``_MIX_LENGTHS`` (3 2^k in [48,
    1536], 5 2^k in [80, 2560]: radix-4 and radix-2 passes, then one of
    radix 12 or 20). Every other length takes the dense core (3072: with 8
    row threads a warp its exchanges would take two wavefronts; factors
    3^2, 5^2 or 15: no network). The register core ignores the radices
    and the lane tile of the dense core."""
    return _pow2(n) or n in _MIX_LENGTHS


# the register core's lane tiles of the strided-axis kernel and their
# codes in csrc/fft_axis.cu: "narrow", the slabs' 256 / P lanes a block;
# "wide", 32 lines a block up to 1024 threads (P >= 16)
_AXIS_TILES = {"narrow": 0, "wide": 1}


def _axis_tile(n: int) -> str:
    """The lane tile the strided-axis kernel's register core launches at
    length n, the one place it is picked, by the threads a line takes
    (P = n / ``_reg_values(n)``): narrow to P = 8 (n = 128 at a power of
    two, 96 and 160 mixed), where a block of 256 threads holds 32 lanes or
    more; wide from P = 16 (256, 192, 320: 32 lanes to P = 32, 16 at 64,
    8 at 128, 4 at 256)."""
    return "narrow" if n // _reg_values(n) <= 8 else "wide"


def _cluster_slab(ny: int, nz: int) -> bool:
    """Whether a register slab (ny, nz) runs in one grid of clusters
    that hold each x-row's slab in shared memory (``ClusterSlab`` in
    ``csrc/regs_kernels.cuh``: 2^14 to 2^17 elements, nz >= 128, ny >=
    64, both powers of two (:func:`_reg_rslab`); clusters of up to 16
    blocks), reading it from device memory once and writing it once;
    other register slabs (every one with a mixed length) run two grids,
    the z rows and then the y lines in place."""
    return (_reg_rslab(ny, nz) and nz >= 128 and ny >= 64
            and 1 << 14 <= ny * nz <= 1 << 17)


def _cluster_irslab(ny: int, m: int) -> bool:
    """Whether the register c2r slab (ny, m) runs in one grid of clusters
    (``irslab_cluster`` in ``csrc/irfft_slab.cu``): the shapes of
    :func:`_cluster_slab` where that kernel spills nothing, 2^14 to 2^15
    elements (the 256^3 slab). At 2^16 and 2^17 it spills 8-156 bytes at
    its 128 registers (``bench/ptxas_spills.py``), and at the 512^3 slab
    two grids ran faster than its clusters of 16 (PERF.md): those run
    two grids."""
    return _cluster_slab(ny, m) and ny * m <= 1 << 15


# the L2 bytes one group of cubes of the register cube may fill between two
# of its barriers (a cube's work buffer, the planar pair its later phases
# read back, is 8 bytes an element): 16 MiB, a third of the H100's 50 MB.
# On an H100 at 700 W (PERF.md; bench/probe_cube.py, seven runs) 64 cubes
# of 32 x 32 x 128 (1 MiB each) ran fastest at G = 16 (0.1240-0.1308 ms;
# G = 25, a 25 MB budget's, 0.1320-0.1419, 1.3-8.5% slower in each run;
# G = 4 and 64 slower still), and 8 x 128^3 (16 MiB each), where both
# budgets give G = 1, at G = 1 in six runs of seven (G = 2 once 1.5%
# faster)
_CUBE_L2_BUDGET = 16 << 20
# the longest z the register cube runs as rows; a longer one (to 32768)
# runs the four-step pair's bodies on fourstep.pick_split(z)
_CUBE_ROWS_MAX = 4096


def _reg_cube(nx: int, ny: int, nz: int) -> bool:
    """Whether the cube kernel (``fft3d_cube`` on (X, Y, Z)) launches the
    register cube (``csrc/fft_cube_regs.cu``): x and y each a power of two
    in [16, 4096] (the column variant) or shorter than 16 (a thread a line
    in registers), z a power of two in [128, 4096] (rows) or in (4096,
    32768] (step 1 then step 3 of the four-step pair). Every other cube
    the gate admits (a mixed length such as Z = 384 or Y = 24, a Y past
    4096) takes the dense kernel (``csrc/fft_cube.cu``). The register cube
    ignores the radices."""
    def cols(n):
        return n < 16 or _pow2(n)
    return cols(nx) and cols(ny) and nz & (nz - 1) == 0 and 128 <= nz <= 32768


def _cube_group(nx: int, ny: int, nz: int,
                budget: int = _CUBE_L2_BUDGET) -> int:
    """G, the cubes of (X, Y, Z) each phase of the register cube covers
    between two barriers: as many as their work buffer (8 bytes an
    element) fits ``budget``, at least one. The input streams once from
    device memory; the later phases read the work buffer back from L2."""
    return max(1, budget // (8 * nx * ny * nz))


def _cube_barriers(b: int, group: int, split: bool) -> int:
    """The grid-wide barriers of one register-cube call on b cubes, G =
    ``group`` a phase: z | y | x, two a group (step 1 | step 3 | y | x,
    three, with the split z). None parts two groups: the next group's z
    writes other cubes than this group's x, and its step 1 rewrites the
    scratch pair two barriers after this group's step 3 read it."""
    return -(-b // group) * (3 if split else 2)


# the register slabs' cost probes (``phases``) and their codes in
# csrc/fft_slab.cu and csrc/rfft_slab.cu; "grids" runs the two-grid
# layout where the cluster one would run
_SLAB_PHASES = {"full": 0, "zonly": 1, "yonly": 2, "copy": 3, "fused": 5,
                "grids": 0}
_RSLAB_PHASES = {"full": 0, "noy": 1, "copy": 3, "nount": 4, "grids": 0}
# the register cube's: each group stops after step 1 of the split z, after
# z, or after z and y (csrc/fft_cube_regs.cu)
_CUBE_PHASES = {"full": 0, "step1": 1, "z": 2, "zy": 3}


def _phase_code(table: dict, phases: str, mode: str, reg: bool) -> int:
    """The C code of a slab's ``phases``. Anything but "full" is a cost
    probe of the register-core kernel on the card (``bench/``): it raises
    for a plain version or the dense core."""
    if phases not in table:
        raise ValueError(f"phases {phases!r}: one of {sorted(table)}")
    if phases != "full" and (mode != "kernel" or not reg):
        raise ValueError(f"phases {phases!r} probe the register-core "
                         "kernel on a CUDA device")
    return table[phases]


def _pick_lane_tile(lanes: int, target: int) -> int:
    target = min(target, lanes)
    if lanes % target == 0 and (target % 128 == 0 or target == lanes):
        return target
    best = max((c for c in range(128, target + 1, 128) if lanes % c == 0),
               default=0)
    return best or lanes


def _nd_route(n: int, mid: int, last: int, tl_target: int) -> bool:
    """Whether the reference's fft_sublane takes its n-D route
    (``_sublane_nd_tiles(...) is not None``). Both routes are one CUDA
    kernel here; the gate only keeps the route counters in step."""
    tz = _pick_lane_tile(last, min(tl_target, last))
    if tz % 128:
        return mid == 1
    want = max(8, (tl_target // tz) & ~7)
    if any(mid % c == 0 for c in range(8, min(mid, want) + 1, 8)):
        return True
    return 12 * n * mid * tz * 4 <= _VMEM_CAP


# --------------------------------------------------------------------------
# tables, dispatch and launch plumbing
# --------------------------------------------------------------------------

_TABLE_KINDS = {
    "core": (tb.core_table, (int, tuple, bool, float)),   # n, stages, inv, s
    "rfft": (tb.rfft_table, (int,)),                       # n
    "crfft": (tb.crfft_table, (int, float)),               # n, scale
    "fourstep": (tb.fourstep_twiddle, (int, int, bool, float)),  # n1, n2, ..
    # one rank's columns [lo, hi) of it, and of the real untangle
    "fourstep_chunk": (tb.fourstep_twiddle_chunk,
                       (int, int, int, int, bool, float, str)),
    "untangle": (tb.untangle_chunk, (int, int, int, str)),  # n, lo, hi, dt
    "half": (tb.half_twiddles, (int, bool, str)),          # n, inverse, dt
    # the unfused engine's complex tables (stockham.py); dtype by name
    "dft": (tb.dft_table, (int, str, bool)),               # n, dtype, inv
    "twiddle": (tb.stage_twiddle, (int, int, str, bool)),  # r, m, ..
    "chirp": (tb.bluestein_chirp, (int, str, bool)),       # n, dtype, inv
    "chirp_fft": (tb.bluestein_spectrum, (int, str, bool)),
}


class TableSet:
    """The tables of one device, keyed by (kind, *args) and built on first
    use: ``get(kind, *args)`` is the ``tables`` function of that kind
    (``core_table``, ``rfft_table``, ``crfft_table``, ``fourstep_twiddle``,
    ``half_twiddles``: the kernels' float32; ``fourstep_twiddle_chunk``,
    ``untangle_chunk``: float32 or float64 by name; ``dft_table``,
    ``stage_twiddle``, ``bluestein_chirp``, ``bluestein_spectrum``: the
    unfused engine's complex64 or complex128) on these args. A Plan keeps
    one and registers its tensors as buffers."""

    def __init__(self, device, tabs: dict | None = None):
        self.device = torch.device(device)
        self.tabs = dict(tabs or {})

    def get(self, kind: str, *args):
        build, types = _TABLE_KINDS[kind]
        key = (kind, *(f(a) for f, a in zip(types, args, strict=True)))
        t = self.tabs.get(key)
        if t is None:
            arr = build(*key[1:])
            t = torch.from_numpy(arr.copy()).to(self.device)
            self.tabs[key] = t
        return t


_DEFAULT_TABLES: dict = {}


def _tables(tables, device) -> TableSet:
    if tables is not None:
        return tables
    ts = _DEFAULT_TABLES.get(device)
    if ts is None:
        ts = _DEFAULT_TABLES[device] = TableSet(device)
    return ts


def _mode(*ts) -> str:
    """'plain' on the CPU, 'kernel' on CUDA, 'shape' on meta."""
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"planar data must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("planar data must be contiguous")
    if dev.type == "cpu":
        return "plain"
    if dev.type == "cuda":
        return "kernel"
    if dev.type == "meta":
        return "shape"
    raise RuntimeError(f"no kernel for device {dev}")


def _pair(xr, xi):
    if xr.shape != xi.shape:
        raise ValueError(f"re/im shapes differ: {tuple(xr.shape)} vs "
                         f"{tuple(xi.shape)}")
    return _mode(xr, xi)


def _on(tab, data):
    """A table for torch ops beside ``data``: on the meta device when the
    data is (a plan's shape-only run), else the table itself."""
    return tab.to("meta") if data.device.type == "meta" else tab


# every kernel wrapper by name, in the order of definition
WRAPPERS: dict = {}


def _dispatching(impl=None, *, arity: int = 2):
    """The wrapper of ``impl(mode, *data, ...)``, whose first ``arity``
    arguments are its data (a planar pair, or with ``arity=1`` one real
    tensor): it dispatches on their device. ``wrapper.plain`` runs the
    plain version on any device (the card's check compares the two on the
    same inputs). The wrapper joins ``WRAPPERS`` with zeroed counts."""
    if impl is None:
        return functools.partial(_dispatching, arity=arity)
    check = _pair if arity == 2 else _mode

    @functools.wraps(impl)
    def wrapper(*args, **kw):
        return impl(check(*args[:arity]), *args, **kw)

    def plain(*args, **kw):
        check(*args[:arity])
        return impl("plain", *args, **kw)

    wrapper.plain = plain
    wrapper.impl = impl
    wrapper.launches = wrapper.plain_calls = wrapper.reg_launches = 0
    del wrapper.__wrapped__
    WRAPPERS[wrapper.__name__] = wrapper
    return wrapper


def _stages(n: int, radices) -> tuple:
    rad = tb._pick_stages(n, radices)
    if rad is None:
        raise ValueError(f"N={n} not expressible as a kernel "
                         f"(radices {radices})")
    return tb.core_stages(rad)


def _radix_args(stages: tuple) -> list:
    return [len(stages), *stages, *(1,) * (3 - len(stages))]


def _ptr(t) -> ctypes.c_void_p:
    """A tensor's device pointer; None passes NULL (an absent input)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _launch(entry: str, tensors, tabs, args) -> None:
    """Call one C entry point on the tensors' device and current stream."""
    dev = tensors[0].device
    for t in tabs:
        if t is not None and t.device != dev:
            raise ValueError(f"table on {t.device}, data on {dev}")
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        code = getattr(lib, entry)(*map(_ptr, tensors), *map(_ptr, tabs),
                                   *args, stream)
    _build.check(code, entry)


def _rows_tile(n: int, block: int, roots: int) -> int:
    """Rows per block of a row tile (stride T | 1) within shared memory."""
    room = (_SMEM_MAX - 8 * roots) // (8 * n)
    if room < 1:
        raise ValueError(f"N={n} does not fit one block's shared memory")
    t = min(block or max(1, min(64, _TILE_BYTES // (8 * n))), room)
    while t > 1 and (t | 1) > room:
        t -= 1
    return t


def _cols_tile(n: int, block: int, roots: int) -> int:
    """Lanes per block of a column tile: a power of two dividing the
    block's threads, within shared memory."""
    room = (_SMEM_MAX - 8 * roots) // (8 * n)
    if room < 1:
        raise ValueError(f"N={n} does not fit one block's shared memory")
    t = 64
    if block:
        t = 1 << (min(block, _THREADS).bit_length() - 1)
    while t > 1 and (8 * n * t > _TILE_BYTES and not block or t > room):
        t //= 2
    return t


def _fits_block(n: int, roots: int) -> bool:
    """Whether one length-n line and ``roots`` stage roots fit one block's
    shared memory (every 2-stage line does; three stages past about 29k
    points do not)."""
    return 8 * n <= _SMEM_MAX - 8 * roots


def _long_last(xr, xi, n: int, stages: tuple, inverse: bool, scale: float,
               alias: bool, tables):
    """c2c along the last axis of lines too long for one block's shared
    memory, on every device: the four-step pair on (rows, r0, n / r0)
    (``fourstep._step1_twiddle``: the first stage, times the twiddle and
    the scale; ``_step3_transposed``: the other stages, written
    transposed into natural order). ``alias`` copies the result over the
    inputs."""
    from .fourstep import _step1_twiddle, _step3_transposed
    r0, n2 = stages[0], n // stages[0]
    rows = xr.numel() // n
    zr, zi = _step1_twiddle(xr.reshape(rows, r0, n2),
                            xi.reshape(rows, r0, n2), r0, n2, (r0,),
                            inverse, scale=scale, tables=tables)
    zr, zi = _step3_transposed(zr, zi, r0, n2, stages[1:], inverse,
                               tables=tables)
    zr, zi = zr.reshape(xr.shape), zi.reshape(xi.shape)
    if alias:
        return xr.copy_(zr), xi.copy_(zi)
    return zr, zi


# --------------------------------------------------------------------------
# plain versions: torch ops on the kernels' own tables
# --------------------------------------------------------------------------

def _core_plain(xr, xi, tab, n: int, stages: tuple):
    """DFT along the last axis of (..., n) with the stage order, tables and
    output map of csrc/fft_core.cuh."""
    lead = xr.shape[:-1]
    m = xr.numel() // n
    ar = xr.reshape(m, n)
    ai = xi.reshape(m, n)
    dev = tab.device
    roots = tab[:n]
    roff, ls = n, n
    for s, r in enumerate(stages):
        ln = ls // r
        k = torch.arange(r, device=dev)
        f = tab[roff:roff + r][(k[:, None] * k[None, :]) % r]
        fr, fi = f[..., 0], f[..., 1]
        # one real product per stage: [yr yi] = [xr xi] @ G^T with the
        # folded G = [[Fr, -Fi], [Fi, Fr]]
        g = torch.cat([torch.cat([fr, -fi], 1), torch.cat([fi, fr], 1)], 0)
        xs = torch.cat([ar.reshape(m, n // ls, r, ln),
                        ai.reshape(m, n // ls, r, ln)], dim=2)
        y = torch.matmul(xs.transpose(-1, -2), g.t())
        yr, yi = y[..., :r].transpose(-1, -2), y[..., r:].transpose(-1, -2)
        if s < len(stages) - 1:
            kj = k[:, None] * torch.arange(ln, device=dev)[None, :]
            tw = roots[kj * (n // ls)]
            twr, twi = tw[..., 0], tw[..., 1]
            yr, yi = yr * twr - yi * twi, yr * twi + yi * twr
        ar, ai = yr.reshape(m, n), yi.reshape(m, n)
        roff += r
        ls = ln
    perm = torch.from_numpy(tb.core_pos(n, stages)).to(dev)
    return (ar[:, perm].reshape(*lead, n), ai[:, perm].reshape(*lead, n))


def _axis_plain(xr, xi, yr, yi, geom, tab, n, stages):
    nb, ny, nz, (isb, isn, isy), (osb, osn, osy) = geom
    shp = (nb, n, ny, nz)
    vr = xr.as_strided(shp, (isb, isn, isy, 1)).permute(0, 2, 3, 1)
    vi = xi.as_strided(shp, (isb, isn, isy, 1)).permute(0, 2, 3, 1)
    ar, ai = _core_plain(vr, vi, tab, n, stages)
    yr.as_strided(shp, (osb, osn, osy, 1)).copy_(ar.permute(0, 3, 1, 2))
    yi.as_strided(shp, (osb, osn, osy, 1)).copy_(ai.permute(0, 3, 1, 2))


def _axis_apply(owner, mode, xr, xi, yr, yi, geom, n: int, stages: tuple,
                inverse: bool, scale: float, block: int, tables,
                tile: str | None = None) -> None:
    """Run the strided-axis transform described by ``geom`` = (nb, ny, nz,
    in strides (b, n, y), out strides (b, n, y)) into (yr, yi): on the
    register core's column variant where :func:`_reg_axis` (``scale`` at
    the store, the lane tile of :func:`_axis_tile`), else on the dense
    core (``block`` lanes a block, the scale in the table). An axis too
    long for one block is moved last, transformed by ``_long_last`` and
    moved back. ``tile``, a key of ``_AXIS_TILES``, overrides that pick:
    a probe (``bench/probe_yconcat.py``; the kernel has the narrow tile
    forward at N = 256 and 1024 beside the lengths routed to it) on a
    CUDA device; it raises for a plain version or the dense core."""
    if tile is not None and (tile not in _AXIS_TILES or mode != "kernel"
                             or not _reg_axis(n) or n & (n - 1)):
        raise ValueError(f"tile {tile!r} probes the register-core kernel "
                         f"on a CUDA device at a power of two, one of "
                         f"{sorted(_AXIS_TILES)}")
    if not _fits_block(n, sum(stages)):
        nb, ny, nz, (isb, isn, isy), (osb, osn, osy) = geom
        shp = (nb, n, ny, nz)
        vr, vi = (t.as_strided(shp, (isb, isn, isy, 1)).movedim(1, -1)
                  .contiguous() for t in (xr, xi))
        ar, ai = _long_last(vr, vi, n, stages, inverse, scale, False, tables)
        yr.as_strided(shp, (osb, osn, osy, 1)).copy_(ar.movedim(-1, 1))
        yi.as_strided(shp, (osb, osn, osy, 1)).copy_(ai.movedim(-1, 1))
        return
    tab = _tables(tables, xr.device).get("core", n, stages, inverse, scale)
    if mode == "shape":
        return
    if mode == "plain":
        owner.plain_calls += 1
        _axis_plain(xr, xi, yr, yi, geom, tab, n, stages)
        return
    nb, ny, nz, ins, outs = geom
    if nb * ny * nz == 0:
        return
    reg = _reg_axis(n)
    t = 0 if reg else _cols_tile(n, block, sum(stages))
    code = _AXIS_TILES[tile or _axis_tile(n)] if reg else 0
    _launch("offt_fft_axis", (xr, xi, yr, yi), (tab,),
            [nb, n, ny, nz, *ins, *outs, *_radix_args(stages), t,
             int(inverse), float(scale), int(reg), code])
    owner.launches += 1
    owner.reg_launches += reg


# --------------------------------------------------------------------------
# the kernel wrappers
# --------------------------------------------------------------------------

@_dispatching
def fft_last(mode, xr, xi, inverse: bool = False, radices=None,
             block_rows: int = 0, precision: str = DEFAULT_PRECISION,
             scale: float = 1.0, alias: bool = False, tables=None):
    """Batched c2c along the last axis of planar (..., N) float32 tensors
    (kernel ``csrc/fft_last.cu``); no 1/N on inverse (callers fold it into
    ``scale``). ``alias=True`` writes over the inputs and returns them; a
    ragged last block is masked, so any batch may alias.

    On a power-of-two N in [16, 4096] and the mixed lengths 3 2^k and
    5 2^k that :func:`_reg_rows` admits the kernel runs the register
    core's rows: ``radices`` is checked but does not shape its passes (any
    valid pick gives the same values), ``block_rows`` is ignored, and
    ``scale`` is applied at the store. Other lengths run the
    dense core on the ``radices`` stages, ``scale`` riding the last stage's
    table; ``block_rows`` sets its rows per CUDA block (0 = as many as fit
    64 KB of shared memory, at most 64). The plain version is the dense
    core's arithmetic on every length."""
    n = xr.shape[-1]
    stages = _stages(n, radices)
    if not _fits_block(n, sum(stages)):
        return _long_last(xr, xi, n, stages, inverse, scale, alias, tables)
    tab = _tables(tables, xr.device).get("core", n, stages, inverse, scale)
    if alias:
        yr, yi = xr, xi
    else:
        yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    if mode == "shape":
        return yr, yi
    if mode == "plain":
        fft_last.plain_calls += 1
        ar, ai = _core_plain(xr, xi, tab, n, stages)
        yr.copy_(ar)
        yi.copy_(ai)
        return yr, yi
    rows = xr.numel() // n
    if rows:
        reg = _reg_rows(n)
        t = 0 if reg else _rows_tile(n, block_rows, sum(stages))
        _launch("offt_fft_last", (xr, xi, yr, yi), (tab,),
                [rows, n, *_radix_args(stages), t, int(inverse), float(scale),
                 int(reg)])
        fft_last.launches += 1
        fft_last.reg_launches += reg
    return yr, yi


@_dispatching
def fft_sublane(mode, xr, xi, axis: int, inverse: bool = False, radices=None,
                block_lanes: int = 0, precision: str = DEFAULT_PRECISION,
                scale: float = 1.0, alias: bool = False, tables=None,
                tile: str | None = None):
    """Batched c2c along any non-last axis (kernel ``csrc/fft_axis.cu``),
    the array viewed as (prefix, N, lanes); no data is transposed.
    ``alias=True`` writes over the inputs.

    On a power-of-two N in [16, 4096] and the mixed lengths 3 2^k and
    5 2^k that :func:`_reg_axis` admits the kernel runs the register
    core's column variant: ``radices`` is checked but does not shape its
    passes, ``block_lanes`` is ignored, and ``scale`` is applied at the
    store, on the lane tile of :func:`_axis_tile`; ``tile="narrow"``
    probes the narrow one at a power of two (``bench/probe_yconcat.py``,
    see ``_axis_apply``). Other
    lengths run the dense core, ``block_lanes`` lanes a CUDA block
    (rounded down to a power of two; 0 = as many as fit 64 KB of shared
    memory, at most 64). The plain version is the dense core's arithmetic
    on every length."""
    axis = axis % xr.ndim
    if axis == xr.ndim - 1:
        raise ValueError("use fft_last for the last axis")
    n = xr.shape[axis]
    stages = _stages(n, radices)
    tl_target = block_lanes or max(128, min(1024,
                                            ((1 << 18) // max(n, 1)) & ~127))
    if axis < xr.ndim - 2:
        mid = math.prod(xr.shape[axis + 1:-1])
        if _nd_route(n, mid, xr.shape[-1], tl_target):
            return _sublane_nd.impl(mode, xr, xi, axis, n, stages, inverse,
                                    scale, alias, block_lanes, tables, tile)
    pre = math.prod(xr.shape[:axis])
    lanes = math.prod(xr.shape[axis + 1:])
    if alias:
        yr, yi = xr, xi
    else:
        yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    st = (n * lanes, lanes, lanes)
    _axis_apply(fft_sublane, mode, xr, xi, yr, yi, (pre, 1, lanes, st, st),
                n, stages, inverse, scale, block_lanes, tables, tile)
    return yr, yi


@_dispatching
def _sublane_nd(mode, xr, xi, axis, n, stages, inverse, scale, alias, block,
                tables=None, tile=None):
    """fft_sublane's route for an axis at or before ndim-3: the array as
    (B, N, MID, last), the same CUDA kernel as the flattened route."""
    b = math.prod(xr.shape[:axis])
    mid = math.prod(xr.shape[axis + 1:-1])
    last = xr.shape[-1]
    if alias:
        yr, yi = xr, xi
    else:
        yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    st = (n * mid * last, mid * last, last)
    _axis_apply(_sublane_nd, mode, xr, xi, yr, yi, (b, mid, last, st, st),
                n, stages, inverse, scale, block, tables, tile)
    return yr, yi


@_dispatching
def fft_slab_yz(mode, xr, xi, inverse: bool = False, rad_y=None, rad_z=None,
                precision: str = DEFAULT_PRECISION, zpad: int = 0,
                z_true: int = 0, scale: float = 1.0, block_rows: int = 0,
                alias: bool = False, tables=None, phases: str = "full"):
    """c2c along the last TWO axes of planar (..., Y, Z) float32 tensors
    (kernel ``csrc/fft_slab.cu``): z, then y, per x-row.

    ``zpad`` appends that many pad lanes to each output row, allocated
    with ``torch.empty`` and never written; the result has trailing shape
    (Y, Z + zpad). ``z_true`` declares that the input's rows carry pad
    lanes past ``z_true`` to skip. ``alias=True`` (no pad either side)
    writes over the inputs. ``block_rows`` is accepted for parity and
    ignored.

    On Y and Z powers of two in [16, 4096] or mixed lengths 3 2^k, 5 2^k
    (:func:`_reg_slab`) the kernel runs the register core: the z rows,
    then the y lines on the column variant, in one grid of clusters
    holding the slab in shared memory (:func:`_cluster_slab`, powers of
    two) or in two grids through the output; ``scale`` is applied at the
    y store and the radices do not shape it. Other
    slabs run the dense core in one grid, a block per x-row, ``scale``
    riding the y tables. The plain version is the dense core's arithmetic
    on every slab. ``phases`` other than "full" are cost probes of the
    register core at Y = Z = 256, forward (``_SLAB_PHASES``;
    ``bench/probe_slabparts.py``): of the cluster layout "zonly", "yonly"
    and "copy"; "grids" (the two-grid layout) and "fused" (one block per
    x-row, the slab read back from the output)."""
    if alias and (zpad or z_true):
        raise ValueError("alias requires identical in/out layouts")
    ny, nz_in = xr.shape[-2], xr.shape[-1]
    nz = z_true or nz_in
    sy, sz = _stages(ny, rad_y), _stages(nz, rad_z)
    if not _fits_block(nz, sum(sz) + sum(sy)):
        # a z line too long for one block: z by fft_last (its long-line
        # route), then y by the strided-axis kernel, in place
        vr, vi = xr, xi
        if nz != nz_in:
            vr, vi = xr[..., :nz].contiguous(), xi[..., :nz].contiguous()
        ar, ai = fft_last(vr, vi, inverse=inverse, radices=sz,
                          tables=tables)
        ar, ai = fft_sublane(ar, ai, -2, inverse=inverse, radices=sy,
                             scale=scale, alias=True, tables=tables)
        if not (alias or zpad):
            return ar, ai
        yr, yi = (xr, xi) if alias else (
            xr.new_empty((*xr.shape[:-1], nz + zpad)) for _ in range(2))
        yr[..., :nz].copy_(ar)
        yi[..., :nz].copy_(ai)
        return yr, yi
    ts = _tables(tables, xr.device)
    tabz = ts.get("core", nz, sz, inverse, 1.0)
    taby = ts.get("core", ny, sy, inverse, scale)
    lead = xr.shape[:-2]
    if alias:
        yr, yi = xr, xi
    else:
        shp = (*lead, ny, nz + zpad)
        yr = torch.empty(shp, dtype=xr.dtype, device=xr.device)
        yi = torch.empty(shp, dtype=xr.dtype, device=xr.device)
    if mode == "shape":
        return yr, yi
    p = math.prod(lead)
    if mode == "plain":
        _phase_code(_SLAB_PHASES, phases, mode, False)
        fft_slab_yz.plain_calls += 1
        ar, ai = _core_plain(xr[..., :nz], xi[..., :nz], tabz, nz, sz)
        ar, ai = _core_plain(ar.transpose(-1, -2), ai.transpose(-1, -2),
                             taby, ny, sy)
        yr[..., :nz].copy_(ar.transpose(-1, -2))
        yi[..., :nz].copy_(ai.transpose(-1, -2))
        return yr, yi
    reg = _reg_slab(ny, nz)
    code = _phase_code(_SLAB_PHASES, phases, mode, reg)
    if p * ny * nz == 0:
        return yr, yi
    roots = sum(sz) + sum(sy)
    tz, ty = (0, 0) if reg else (_rows_tile(nz, 0, roots),
                                 _cols_tile(ny, 0, roots))
    cluster = reg and _cluster_slab(ny, nz) and phases != "grids"
    _launch("offt_fft_slab", (xr, xi, yr, yi), (tabz, taby),
            [p, ny, nz, nz_in, nz + zpad, *_radix_args(sz),
             *_radix_args(sy), tz, ty, int(inverse), float(scale), int(reg),
             int(cluster), code])
    fft_slab_yz.launches += 1
    fft_slab_yz.reg_launches += reg
    return yr, yi


@_dispatching
def fft_x_from_padded(mode, xr3, xi3, z_true: int, inverse: bool = False,
                      radices=None, precision: str = DEFAULT_PRECISION,
                      scale: float = 1.0, out_lanes: int = 0, ty: int = 8,
                      tz: int = 128, y_true: int = 0, tables=None):
    """x-axis c2c over a (..., X, Y, Z+pad) padded intermediate, reading
    only the first ``z_true`` lanes of each row; writes an unpadded
    (..., X, Y, zo) result, zo = max(out_lanes, z_true), whose lanes past
    ``z_true`` are allocated and not written. ``y_true`` (< Y) skips
    trailing input rows. Kernel ``csrc/fft_axis.cu`` with pitched reads,
    on the register core's column variant where :func:`_reg_axis`;
    ``ty``/``tz`` are accepted for parity and ignored (the kernel picks
    its own lane tile)."""
    lead = xr3.shape[:-3]
    n, ny_in, zp = xr3.shape[-3:]
    ny = y_true or ny_in
    stages = _stages(n, radices)
    zo = max(out_lanes, z_true)
    shp = (*lead, n, ny, zo)
    yr = torch.empty(shp, dtype=xr3.dtype, device=xr3.device)
    yi = torch.empty(shp, dtype=xr3.dtype, device=xr3.device)
    b = math.prod(lead)
    geom = (b, ny, z_true, (n * ny_in * zp, ny_in * zp, zp),
            (n * ny * zo, ny * zo, zo))
    _axis_apply(fft_x_from_padded, mode, xr3, xi3, yr, yi, geom, n, stages,
                inverse, scale, 0, tables)
    return yr, yi


@_dispatching
def fft_x_to_padded(mode, xr3, xi3, zpad: int = _STRIDE_PAD,
                    inverse: bool = False, radices=None,
                    precision: str = DEFAULT_PRECISION, scale: float = 1.0,
                    z_true: int = 0, ty: int = 8, tz: int = 128, tables=None):
    """x-axis c2c over an unpadded (..., X, Y, Z) array into a Z-padded
    (..., X, Y, Zt + zpad) one, Zt = ``z_true`` or Z: only the first Zt
    lanes of each input row are transformed (the c2r path drops its
    Nyquist lane this way) and the pad lanes are allocated and not
    written. Kernel ``csrc/fft_axis.cu`` with pitched writes, on the
    register core's column variant where :func:`_reg_axis`; ``ty``/``tz``
    are accepted for parity and ignored."""
    lead = xr3.shape[:-3]
    n, ny, z = xr3.shape[-3:]
    zt = z_true or z
    if zt > z:
        raise ValueError(f"z_true={z_true} exceeds the {z} input lanes")
    stages = _stages(n, radices)
    zo = zt + zpad
    shp = (*lead, n, ny, zo)
    yr = torch.empty(shp, dtype=xr3.dtype, device=xr3.device)
    yi = torch.empty(shp, dtype=xr3.dtype, device=xr3.device)
    geom = (math.prod(lead), ny, zt, (n * ny * z, ny * z, z),
            (n * ny * zo, ny * zo, zo))
    _axis_apply(fft_x_to_padded, mode, xr3, xi3, yr, yi, geom, n, stages,
                inverse, scale, 0, tables)
    return yr, yi


def _untangle_plain(vr, vi, w):
    """The r2c untangle of V = DFT_M(v) (natural order, (..., M)) into the
    packed half-spectrum: X[k] = E - i W^k O with E, O = (V[k] +- conj
    V[M-k]) / 2, and row 0 = (Re V0 + Im V0) + i (Re V0 - Im V0)."""
    m = vr.shape[-1]
    rev = (-torch.arange(m, device=vr.device)) % m
    br, bi = vr[..., rev], -vi[..., rev]
    er, ei = (vr + br) * 0.5, (vi + bi) * 0.5
    orr, oi = (vr - br) * 0.5, (vi - bi) * 0.5
    wr, wi = w[:, 0], w[:, 1]
    xr = er + wr * oi + wi * orr
    xi = ei - wr * orr + wi * oi
    xr[..., 0] = vr[..., 0] + vi[..., 0]
    xi[..., 0] = vr[..., 0] - vi[..., 0]
    return xr, xi


def _retangle_plain(xr, xi, ab):
    """The c2r re-tangle V[k] = a[k] X[k] + b[k] conj X[(M-k) mod M] with
    the (M, 2, 2) table of ``tables.crfft_table``."""
    m = xr.shape[-1]
    rev = (-torch.arange(m, device=xr.device)) % m
    cr, ci = xr[..., rev], -xi[..., rev]
    a_r, a_i, b_r, b_i = ab[:, 0, 0], ab[:, 0, 1], ab[:, 1, 0], ab[:, 1, 1]
    return (a_r * xr - a_i * xi + b_r * cr - b_i * ci,
            a_r * xi + a_i * xr + b_r * ci + b_i * cr)


@_dispatching(arity=1)
def rfft_slab_yz(mode, x, rad_y=None, rad_z=None,
                 precision: str = DEFAULT_PRECISION, zpad: int = 0,
                 block_rows: int = 0, tables=None, phases: str = "full"):
    """r2c along z, then c2c along y, of real (..., Y, N) float32 (kernel
    ``csrc/rfft_slab.cu``): the packed planar half-spectrum
    (..., Y, M + zpad), M = N/2, whose plane 0 carries X[0] + i X[M].
    Unscaled. The ``zpad`` pad lanes are allocated and never written;
    ``block_rows`` is accepted for parity and ignored.

    On Y and M powers of two in [16, 4096] (:func:`_reg_rslab`) the
    kernel runs the register core: the r2c rows (float2 pairs, the M-point
    core, the untangle), then the y lines on the column variant, in one grid of
    clusters holding the slab in shared memory (:func:`_cluster_slab` of
    (Y, M)) or in two grids through the output; the radices do not shape
    it. Other slabs run the dense core in one grid, a block per x-row.
    The plain version is the dense core's arithmetic on every slab.
    ``phases`` other than "full" are cost probes of the register core's
    cluster layout at Y = 512, M = 256 (``_RSLAB_PHASES``;
    ``bench/probe_rslab512.py``): "noy", "nount" and "copy"; "grids" runs
    the two-grid layout where the cluster one would run."""
    ny, n = x.shape[-2], x.shape[-1]
    if n % 2:
        raise ValueError(f"rfft slab needs an even N, got {n}")
    m = n // 2
    sy, sz = _stages(ny, rad_y), _stages(m, rad_z)
    ts = _tables(tables, x.device)
    tabz = ts.get("core", m, sz, False, 1.0)
    taby = ts.get("core", ny, sy, False, 1.0)
    w = ts.get("rfft", n)
    lead = x.shape[:-2]
    shp = (*lead, ny, m + zpad)
    yr = torch.empty(shp, dtype=x.dtype, device=x.device)
    yi = torch.empty(shp, dtype=x.dtype, device=x.device)
    if mode == "shape":
        return yr, yi
    p = math.prod(lead)
    if mode == "plain":
        _phase_code(_RSLAB_PHASES, phases, mode, False)
        rfft_slab_yz.plain_calls += 1
        v = x.reshape(*lead, ny, m, 2)
        ar, ai = _core_plain(v[..., 0], v[..., 1], tabz, m, sz)
        ar, ai = _untangle_plain(ar, ai, w)
        ar, ai = _core_plain(ar.transpose(-1, -2), ai.transpose(-1, -2),
                             taby, ny, sy)
        yr[..., :m].copy_(ar.transpose(-1, -2))
        yi[..., :m].copy_(ai.transpose(-1, -2))
        return yr, yi
    reg = _reg_rslab(ny, m)
    code = _phase_code(_RSLAB_PHASES, phases, mode, reg)
    if p * ny * m == 0:
        return yr, yi
    if x.data_ptr() % 8:
        # the kernel reads (x[2j], x[2j+1]) as one float2
        raise ValueError("rfft_slab_yz needs an 8-byte aligned input")
    roots = sum(sz) + sum(sy)
    tz, ty = (0, 0) if reg else (_rows_tile(m, 0, roots),
                                 _cols_tile(ny, 0, roots))
    cluster = _cluster_slab(ny, m) and phases != "grids"
    _launch("offt_rfft_slab", (x, yr, yi), (tabz, taby, w),
            [p, ny, m, m + zpad, *_radix_args(sz), *_radix_args(sy), tz, ty,
             int(reg), int(cluster), code])
    rfft_slab_yz.launches += 1
    rfft_slab_yz.reg_launches += reg
    return yr, yi


@_dispatching
def irfft_slab_yz(mode, xr, xi, n: int, rad_y=None, rad_z=None,
                  precision: str = DEFAULT_PRECISION, scale: float = 1.0,
                  block_rows: int = 0, side_r=None, side_i=None,
                  tables=None):
    """Inverse c2c along y, then c2r along z, of a packed planar
    (..., Y, M + pad) half-spectrum in one launch (kernel
    ``csrc/irfft_slab.cu``): the real (..., Y, N) result, N = ``n`` = 2M.
    Input lanes past M are skipped. ``scale`` rides the re-tangle table
    (row 0 included); the cores are unscaled, so the exact inverse of
    unscaled x and y passes takes 1/(Nx*Ny*M). ``side_r``/``side_i``, of
    shape (..., Y), are a Nyquist plane injected into plane 0 as
    + i*side before the y pass. ``block_rows`` is ignored.

    On Y and M powers of two in [16, 4096] (:func:`_reg_rslab` of (Y, M))
    the kernel runs the register core: the y lines on the column variant,
    then the c2r rows (the re-tangle as the M-point core loads), in one
    grid of clusters holding the slab in shared memory
    (:func:`_cluster_irslab`) or in two grids through a planar
    (..., Y, M) scratch; the radices do not shape it. Other slabs run the
    dense core in one grid, a block per x-row. The plain version is the
    dense core's arithmetic on every slab."""
    ny, lanes = xr.shape[-2], xr.shape[-1]
    m = n // 2
    if n != 2 * m or m > lanes:
        raise ValueError(f"N={n} needs an even length with N/2 <= {lanes} "
                         "input lanes")
    lead = xr.shape[:-2]
    p = math.prod(lead)
    if (side_r is None) != (side_i is None):
        raise ValueError("side_r and side_i come together")
    if side_r is not None:
        _mode(xr, side_r, side_i)
        if side_r.numel() != p * ny or side_i.numel() != p * ny:
            raise ValueError(f"side plane of {side_r.numel()} values, want "
                             f"{p * ny}")
    sy, sz = _stages(ny, rad_y), _stages(m, rad_z)
    ts = _tables(tables, xr.device)
    tabz = ts.get("core", m, sz, True, 1.0)
    taby = ts.get("core", ny, sy, True, 1.0)
    ab = ts.get("crfft", n, scale)
    out = torch.empty((*lead, ny, n), dtype=xr.dtype, device=xr.device)
    if mode == "shape":
        return out
    if mode == "plain":
        irfft_slab_yz.plain_calls += 1
        ar, ai = xr[..., :m], xi[..., :m]
        if side_r is not None:
            ar, ai = ar.clone(), ai.clone()
            ar[..., 0] -= side_i.reshape(*lead, ny)
            ai[..., 0] += side_r.reshape(*lead, ny)
        ar, ai = _core_plain(ar.transpose(-1, -2), ai.transpose(-1, -2),
                             taby, ny, sy)
        ar, ai = _retangle_plain(ar.transpose(-1, -2), ai.transpose(-1, -2),
                                 ab)
        ar, ai = _core_plain(ar, ai, tabz, m, sz)
        out.copy_(torch.stack([ar, ai], -1).reshape(out.shape))
        return out
    if p * ny * m == 0:
        return out
    reg = _reg_rslab(ny, m)
    cluster = reg and _cluster_irslab(ny, m)
    sr = si = None
    if reg and not cluster:
        sr = torch.empty((p, ny, m), dtype=xr.dtype, device=xr.device)
        si = torch.empty_like(sr)
    roots = sum(sz) + sum(sy)
    tz, ty = (0, 0) if reg else (_rows_tile(m, 0, roots),
                                 _cols_tile(ny, 0, roots))
    _launch("offt_irfft_slab", (xr, xi, side_r, side_i, out, sr, si),
            (tabz, taby, ab),
            [p, ny, m, lanes, *_radix_args(sz), *_radix_args(sy), tz, ty,
             int(reg), int(cluster)])
    irfft_slab_yz.launches += 1
    irfft_slab_yz.reg_launches += reg
    return out


@_dispatching
def _assemble_mp1(mode, yr, yi, ar, ai, br, bi):
    """Packed planar (..., Y, M) plus the split planes a (k = 0) and b
    (k = M), planar pairs of shape (..., Y), into the numpy layout
    (..., Y, M + 1) in one pass (kernel ``csrc/assemble_mp1.cu``): lane 0
    takes a, lane M takes b, lanes 1..M-1 are copied."""
    _mode(yr, ar, ai, br, bi)
    m = yr.shape[-1]
    planes = yr.numel() // max(m, 1)
    if any(t.numel() != planes for t in (ar, ai, br, bi)):
        raise ValueError(f"planes a, b need {planes} values each")
    shp = (*yr.shape[:-1], m + 1)
    o_r = torch.empty(shp, dtype=yr.dtype, device=yr.device)
    o_i = torch.empty(shp, dtype=yr.dtype, device=yr.device)
    if mode == "shape":
        return o_r, o_i
    if mode == "plain":
        _assemble_mp1.plain_calls += 1
        for o, y, lo, hi in ((o_r, yr, ar, br), (o_i, yi, ai, bi)):
            o[..., :m].copy_(y)
            o[..., 0].copy_(lo.reshape(o.shape[:-1]))
            o[..., m].copy_(hi.reshape(o.shape[:-1]))
        return o_r, o_i
    if planes:
        _launch("offt_assemble_mp1", (yr, yi, ar, ai, br, bi, o_r, o_i), (),
                [planes, m])
        _assemble_mp1.launches += 1
    return o_r, o_i


@_dispatching(arity=1)
def rfft_last_planar(mode, x, radices=None,
                     precision: str = DEFAULT_PRECISION, block_rows: int = 0,
                     packed: bool = False, scale: float = 1.0, tables=None):
    """r2c along the last axis of real (..., N) float32 (kernel
    ``csrc/rfft_last.cu``): the planar (..., N/2 + 1) numpy layout, or
    with ``packed=True`` the packed (..., N/2) layout whose lane 0 carries
    X[0] + i X[N/2]. One M-point core (M = N/2) on v[j] = x[2j] + i
    x[2j+1], then the O(M) untangle. The reference has no ``scale`` and
    post-multiplies.

    On M a power of two in [16, 4096] (:func:`_reg_core`) the kernel runs
    the register core: ``radices`` (the reference's ``_pick_2stage`` of M)
    is checked but does not shape its passes, ``block_rows`` is ignored,
    and ``scale`` is applied at the store. Other M run the dense core on
    the pick, ``scale`` riding its last stage's table; ``block_rows`` sets
    its rows per CUDA block. The plain version is the dense core's
    arithmetic on every M."""
    n = x.shape[-1]
    m = n // 2
    pick = tb._pick_2stage(m, radices)
    if pick is None or n % 2:
        raise ValueError(f"N={n} not expressible for the r2c kernel")
    stages = tb.core_stages(pick)
    ts = _tables(tables, x.device)
    tab = ts.get("core", m, stages, False, scale)
    w = ts.get("rfft", n)
    lead = x.shape[:-1]
    mo = m if packed else m + 1
    yr = torch.empty((*lead, mo), dtype=x.dtype, device=x.device)
    yi = torch.empty((*lead, mo), dtype=x.dtype, device=x.device)
    if mode == "shape":
        return yr, yi
    if mode == "plain":
        rfft_last_planar.plain_calls += 1
        v = x.reshape(*lead, m, 2)
        ar, ai = _core_plain(v[..., 0], v[..., 1], tab, m, stages)
        ar, ai = _untangle_plain(ar, ai, w)
        if packed:
            yr.copy_(ar)
            yi.copy_(ai)
            return yr, yi
        # the packed lane 0 (X0 + i XM) splits into lanes 0 and M
        yr[..., 1:m].copy_(ar[..., 1:])
        yi[..., 1:m].copy_(ai[..., 1:])
        yr[..., 0], yr[..., m] = ar[..., 0], ai[..., 0]
        yi[..., 0] = yi[..., m] = 0.0
        return yr, yi
    rows = x.numel() // n
    if rows:
        reg = _reg_core(m)
        if x.data_ptr() % 8:
            # the kernel reads (x[2j], x[2j+1]) as one float2
            raise ValueError("rfft_last_planar needs an 8-byte aligned input")
        t = 0 if reg else _rows_tile(m, block_rows, sum(stages))
        _launch("offt_rfft_last", (x, yr, yi), (tab, w),
                [rows, m, *_radix_args(stages), t, int(packed), float(scale),
                 int(reg)])
        rfft_last_planar.launches += 1
        rfft_last_planar.reg_launches += reg
    return yr, yi


@_dispatching
def icrfft_last_planar(mode, xr, xi, n: int = 0, radices=None,
                       precision: str = DEFAULT_PRECISION, scale: float = 0.0,
                       block_rows: int = 0, tables=None):
    """Packed c2r along the last axis (kernel ``csrc/icrfft_last.cu``):
    a planar (..., M) half-spectrum whose lane 0 carries X[0] + i X[M] to
    real (..., N) float32, N = ``n`` = 2M. The re-tangle, then one
    inverse M-point core (the reference's ``_pick_2stage``) and the
    interleave x[2j] = Re v[j], x[2j+1] = Im v[j]. ``scale`` rides the
    re-tangle table (row 0 included) and defaults to 1/M, the exact
    inverse; the core is unscaled.

    On a power-of-two M in [16, 4096] (:func:`_reg_core`) the kernel runs
    the register core's c2r rows (the re-tangle as the core loads, the
    kernel of ``irfft_slab_yz``'s rows): ``radices`` is checked but does
    not shape its passes, and ``block_rows`` is ignored. Other lengths run
    the dense core on the ``radices`` stages, ``block_rows`` rows a CUDA
    block. The plain version is the dense core's arithmetic on every
    length."""
    m = xr.shape[-1]
    n = n or 2 * m
    pick = tb._pick_2stage(m, radices)
    if pick is None or n != 2 * m:
        raise ValueError(f"M={m}, N={n} not expressible for the packed c2r "
                         "kernel")
    stages = tb.core_stages(pick)
    ts = _tables(tables, xr.device)
    tab = ts.get("core", m, stages, True, 1.0)
    ab = ts.get("crfft", n, scale or 1.0 / m)
    out = torch.empty((*xr.shape[:-1], n), dtype=xr.dtype, device=xr.device)
    if mode == "shape":
        return out
    if mode == "plain":
        icrfft_last_planar.plain_calls += 1
        ar, ai = _retangle_plain(xr, xi, ab)
        ar, ai = _core_plain(ar, ai, tab, m, stages)
        out.copy_(torch.stack([ar, ai], -1).reshape(out.shape))
        return out
    rows = xr.numel() // m
    if rows:
        reg = _reg_core(m)
        t = 0 if reg else _rows_tile(m, block_rows, sum(stages))
        _launch("offt_icrfft_last", (xr, xi, out), (tab, ab),
                [rows, m, *_radix_args(stages), t, int(reg)])
        icrfft_last_planar.launches += 1
        icrfft_last_planar.reg_launches += reg
    return out


@_dispatching
def fft3d_cube(mode, xr, xi, inverse: bool = False, rad_z=None, rad_y=None,
               rad_x=None, precision: str = DEFAULT_PRECISION,
               out_scale: float = 1.0, tables=None, phases: str = "full"):
    """c2c along all three trailing axes of planar (..., X, Y, Z) float32
    cubes in one cooperative launch, for the shapes ``can_fuse_cube``
    admits. The inverse's 1/(XYZ) and ``out_scale`` ride the last stage.

    Where :func:`_reg_cube` holds, the kernel is the register cube
    (``csrc/fft_cube_regs.cu``): G cubes a phase (:func:`_cube_group`),
    z first, as rows or, past 4096, step 1 and step 3 of the four-step
    pair on ``fourstep.pick_split(Z)`` through a scratch pair of G cubes,
    then y and x on the column variant (a thread a line at a length under
    16), the scale at x's store; it ignores the radices, and counts
    ``fft3d_cube.reg_launches``; ``fft3d_cube.last`` holds its last
    launch's G, barriers, cooperative grid, blocks an SM and shared
    memory. ``phases`` other than "full" are cost probes of the register
    cube on the card (``bench/probe_cube.py``, ``_CUBE_PHASES``): each
    group stops after step 1 of the split z ("step1"), after z ("z") or
    after z and y ("zy"). Every other cube runs the dense kernel
    (``csrc/fft_cube.cu``) on the radices, a z line too long for one
    block's shared memory through its split z phase and a one-cube scratch
    pair. The plain version is the dense kernel's arithmetic."""
    if xr.ndim < 3:
        raise ValueError(f"a cube needs three axes, got {tuple(xr.shape)}")
    nx, ny, nz = xr.shape[-3:]
    if not can_fuse_cube(nx, ny, nz, rad_x, rad_y, rad_z, precision):
        raise ValueError(f"cube ({nx},{ny},{nz}) not fusable")
    reg = mode == "kernel" and _reg_cube(nx, ny, nz)
    code = _phase_code(_CUBE_PHASES, phases, mode, reg)
    if phases == "step1" and nz <= _CUBE_ROWS_MAX:
        raise ValueError(f"phases 'step1' probes the split z, not Z={nz}")
    sx, sy, sz = _stages(nx, rad_x), _stages(ny, rad_y), _stages(nz, rad_z)
    roots = sum(sx) + sum(sy) + sum(sz)
    zsplit = not _fits_block(nz, roots)
    if zsplit and len(sz) < 2:
        raise ValueError(f"Z={nz} fits no block and has one stage")
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    scale = out_scale * ((1.0 / (nx * ny * nz)) if inverse else 1.0)
    b = xr.numel() // max(nx * ny * nz, 1)
    ts = _tables(tables, xr.device)
    if reg:
        if b:
            _cube_regs(xr, xi, yr, yi, b, inverse, scale, code, ts)
        return yr, yi
    tabx = ts.get("core", nx, sx, inverse, 1.0)
    taby = ts.get("core", ny, sy, inverse, 1.0)
    tabz = ts.get("core", nz, sz, inverse, scale)
    tabz2 = tabz
    if zsplit:
        tabz2 = ts.get("core", nz // sz[0], sz[1:], inverse, scale)
    if mode == "shape":
        return yr, yi
    if mode == "plain":
        fft3d_cube.plain_calls += 1
        ar, ai = xr.reshape(b, nx, ny, nz), xi.reshape(b, nx, ny, nz)
        ar, ai = _core_plain(ar.permute(0, 2, 3, 1), ai.permute(0, 2, 3, 1),
                             tabx, nx, sx)
        ar, ai = ar.permute(0, 3, 1, 2), ai.permute(0, 3, 1, 2)
        ar, ai = _core_plain(ar.transpose(-1, -2), ai.transpose(-1, -2),
                             taby, ny, sy)
        ar, ai = _core_plain(ar.transpose(-1, -2), ai.transpose(-1, -2),
                             tabz, nz, sz)
        yr.copy_(ar.reshape(yr.shape))
        yi.copy_(ai.reshape(yi.shape))
        return yr, yi
    if not b:
        return yr, yi
    tx, ty = _cols_tile(nx, 0, roots), _cols_tile(ny, 0, roots)
    tz = t1 = t2 = 1
    sr = si = None
    if zsplit:
        t1 = _cols_tile(sz[0], 0, roots)
        t2 = _rows_tile(nz // sz[0], 0, roots)
        sr = torch.empty((nx, ny, nz), dtype=xr.dtype, device=xr.device)
        si = torch.empty_like(sr)
    else:
        tz = _rows_tile(nz, 0, roots)
    _launch("offt_fft_cube", (xr, xi, yr, yi, sr, si),
            (tabx, taby, tabz, tabz2),
            [b, nx, ny, nz, *_radix_args(sx), *_radix_args(sy),
             *_radix_args(sz), tx, ty, tz, int(zsplit), t1, t2])
    fft3d_cube.launches += 1
    return yr, yi


def _cube_regs(xr, xi, yr, yi, b: int, inverse: bool, scale: float,
               phases: int, ts) -> None:
    """Launch the register cube on b cubes (``fft3d_cube``'s kernel route
    where :func:`_reg_cube` holds): the core tables of X, Y and Z (the
    kernel reads their first N rows, the roots), or with the split z those
    of n1 and n2 and the four-step twiddle, and a scratch pair of G cubes.
    ``phases`` is the C code of a cost probe (``_CUBE_PHASES``). Records
    the launch in ``fft3d_cube.last``."""
    from .fourstep import pick_split
    nx, ny, nz = xr.shape[-3:]
    vol = nx * ny * nz
    g = min(_cube_group(nx, ny, nz), b)
    split = pick_split(nz) if nz > _CUBE_ROWS_MAX else None

    def core(n):
        return ts.get("core", n, _stages(n, None), inverse, 1.0)
    tabs = [core(nx), core(ny)]
    sr = si = None
    n1 = n2 = 0
    if split:
        n1, n2 = split
        tabs += [core(n1), core(n2), ts.get("fourstep", n1, n2, inverse,
                                            1.0)]
        sr = torch.empty(g * vol, dtype=xr.dtype, device=xr.device)
        si = torch.empty_like(sr)
    else:
        tabs += [core(nz), None, None]
    info = (ctypes.c_int * 3)()
    _launch("offt_fft_cube_regs", (xr, xi, yr, yi, sr, si), tabs,
            [b, nx, ny, nz, n1, n2, g, int(inverse), scale, phases,
             ctypes.addressof(info)])
    fft3d_cube.launches += 1
    fft3d_cube.reg_launches += 1
    fft3d_cube.last = {"group": g, "split": split,
                       "barriers": _cube_barriers(b, g, bool(split)),
                       "grid": info[0], "per_sm": info[1], "smem": info[2]}


fft3d_cube.last = None


def reset_counts() -> None:
    """Zero every wrapper's launch, register-core and plain-call counts."""
    for f in WRAPPERS.values():
        f.launches = f.reg_launches = f.plain_calls = 0


def counts() -> dict:
    """{wrapper name: (launches, plain_calls)}."""
    return {k: (f.launches, f.plain_calls) for k, f in WRAPPERS.items()}


def kernel_launches(name: str, reg: bool = False) -> int:
    """Launches of one CUDA kernel of KERNELS, summed over its wrappers
    (``reg=True``: those on the register core)."""
    return sum(WRAPPERS[w].reg_launches if reg else WRAPPERS[w].launches
               for w in KERNELS[name]["wrappers"])


# --------------------------------------------------------------------------
# planar 1-D dispatch + the full 3-D transform (the reference's routing)
# --------------------------------------------------------------------------

def fft_1d_planar(xr, xi, axis: int = -1, inverse: bool = False,
                  radices=None, scale: bool = True,
                  precision: str = DEFAULT_PRECISION, block: int = 0,
                  out_scale: float = 1.0, alias: bool = False, x_tile=None,
                  tables=None):
    """Planar 1-D FFT along ``axis`` (numpy fft/ifft semantics); the
    inverse 1/N and ``out_scale`` ride the kernel's tables."""
    axis = axis % xr.ndim
    n = xr.shape[axis]
    knob = out_scale * ((1.0 / n) if (inverse and scale) else 1.0)
    if n == 1:
        if knob == 1.0:
            return xr, xi
        if alias:
            return xr.mul_(knob), xi.mul_(knob)
        return xr * knob, xi * knob
    if axis == xr.ndim - 1:
        return fft_last(xr, xi, inverse=inverse, radices=radices,
                        precision=precision, block_rows=block, scale=knob,
                        alias=alias, tables=tables)
    if (axis == xr.ndim - 3 and not alias
            and bank_conflict_stride(xr.shape[-2], xr.shape[-1])
            and can_use_padded_x(n, xr.shape[-2], xr.shape[-1], radices)):
        # the reference pays one pad copy to break the row stride here
        ty, tz = x_tile or (8, 128)
        pad = torch.nn.functional.pad
        return fft_x_from_padded(pad(xr, (0, _STRIDE_PAD)),
                                 pad(xi, (0, _STRIDE_PAD)), xr.shape[-1],
                                 inverse=inverse, radices=radices,
                                 precision=precision, scale=knob, ty=ty,
                                 tz=tz, tables=tables)
    return fft_sublane(xr, xi, axis, inverse=inverse, radices=radices,
                       precision=precision, block_lanes=block, scale=knob,
                       alias=alias, tables=tables)


def fft3d_planar(xr, xi, inverse: bool = False, rad_z=None, rad_y=None,
                 rad_x=None, precision: str = DEFAULT_PRECISION,
                 block: int = 0, slab_rows: int = 0, out_scale: float = 1.0,
                 x_tile=None, in_place: bool = False, tables=None):
    """Full 3-D c2c over the last three axes of planar float32 tensors,
    with the routes and scale placement of the reference's fft3d_planar:
    the fused (y, z) slab when it fuses, then one x pass (pitched over a
    Z-padded intermediate when the stride gate fires); the 2-D route when
    nx == 1; three axis passes when the slab does not fuse.

    ``out_scale`` rides the final stage's tables. ``in_place=True`` runs
    every kernel aliased, so the inputs are overwritten and returned."""
    ax, ay, az = xr.ndim - 3, xr.ndim - 2, xr.ndim - 1
    kw = {"precision": precision, "block": block, "tables": tables}
    nx, ny, nz = xr.shape[ax], xr.shape[ay], xr.shape[az]
    fuse = can_fuse_slab(ny, nz, rad_y, rad_z)
    slab_kw = {"rad_y": rad_y, "rad_z": rad_z, "precision": precision,
               "block_rows": slab_rows, "tables": tables}
    if in_place:
        if nx == 1:
            xr, xi = fft_1d_planar(xr, xi, az, inverse=inverse,
                                   radices=rad_z, alias=True, **kw)
            return fft_1d_planar(xr, xi, ay, inverse=inverse,
                                 radices=rad_y, out_scale=out_scale,
                                 alias=True, **kw)
        if not fuse:
            raise ValueError("in_place needs a fusable (y,z) slab")
        if not inverse:
            xr, xi = fft_slab_yz(xr, xi, alias=True, **slab_kw)
            return fft_sublane(xr, xi, ax, radices=rad_x,
                               precision=precision, block_lanes=block,
                               scale=out_scale, alias=True, tables=tables)
        xr, xi = fft_sublane(xr, xi, ax, inverse=True, radices=rad_x,
                             precision=precision, block_lanes=block,
                             scale=1.0 / nx, alias=True, tables=tables)
        return fft_slab_yz(xr, xi, inverse=True,
                           scale=out_scale / (ny * nz), alias=True,
                           **slab_kw)
    if nx == 1:
        if not inverse:
            xr, xi = fft_1d_planar(xr, xi, az, radices=rad_z, **kw)
            return fft_1d_planar(xr, xi, ay, radices=rad_y,
                                 out_scale=out_scale, **kw)
        xr, xi = fft_1d_planar(xr, xi, ay, inverse=True, radices=rad_y, **kw)
        return fft_1d_planar(xr, xi, az, inverse=True, radices=rad_z,
                             out_scale=out_scale, **kw)
    use_padded_x = (fuse and can_use_padded_x(nx, ny, nz, rad_x)
                    and bank_conflict_stride(ny, nz))
    if use_padded_x:
        # forward and inverse both take the forward order (slab into the
        # padded intermediate, then the pitched x pass); the whole scale
        # rides the x tables
        ty, tz = x_tile or (8, 128)
        scale = out_scale / (nx * ny * nz) if inverse else out_scale
        xr, xi = fft_slab_yz(xr, xi, inverse=inverse, zpad=_STRIDE_PAD,
                             **slab_kw)
        return fft_x_from_padded(xr, xi, nz, inverse=inverse, radices=rad_x,
                                 precision=precision, scale=scale, ty=ty,
                                 tz=tz, tables=tables)
    if not inverse:
        if fuse:
            xr, xi = fft_slab_yz(xr, xi, **slab_kw)
        else:
            xr, xi = fft_1d_planar(xr, xi, az, radices=rad_z, **kw)
            xr, xi = fft_1d_planar(xr, xi, ay, radices=rad_y, **kw)
        return fft_1d_planar(xr, xi, ax, radices=rad_x, out_scale=out_scale,
                             x_tile=x_tile, **kw)
    xr, xi = fft_1d_planar(xr, xi, ax, inverse=True, radices=rad_x,
                           x_tile=x_tile, **kw)
    if fuse:
        return fft_slab_yz(xr, xi, inverse=True, scale=out_scale / (ny * nz),
                           **slab_kw)
    xr, xi = fft_1d_planar(xr, xi, ay, inverse=True, radices=rad_y, **kw)
    return fft_1d_planar(xr, xi, az, inverse=True, radices=rad_z,
                         out_scale=out_scale, **kw)


# --------------------------------------------------------------------------
# packed r2c / c2r over the last three axes (the reference's routing)
# --------------------------------------------------------------------------

def _plane0_split(yr, yi):
    """Split the packed plane 0 (= fft_xy(X_0) + i fft_xy(X_M)) into the
    true k = 0 and k = M planes by 2-D conjugate symmetry; complex (a, b)
    of shape (..., X, Y). Plain torch ops, as the reference's are plain
    jnp (pallas_fft.py:1989)."""
    p = torch.complex(yr[..., 0], yi[..., 0])
    rev = torch.roll(torch.flip(p, (-2, -1)), (1, 1), (-2, -1)).conj()
    return 0.5 * (p + rev), -0.5j * (p - rev)


def unpack_rfft3d(yr, yi):
    """The packed half-spectrum (..., M) to the numpy rfftn layout
    (..., M + 1): the plane-0 split, then one assembly pass."""
    a, b = _plane0_split(yr, yi)
    return _assemble_mp1(yr, yi, a.real.contiguous(), a.imag.contiguous(),
                         b.real.contiguous(), b.imag.contiguous())


def pack_rfft3d(yr, yi):
    """A numpy-layout half-spectrum (..., M + 1) to the packed (..., M)
    form (plane 0 := plane 0 + i plane M). Plain torch ops."""
    m = yr.shape[-1] - 1
    pr = yr[..., :1] - yi[..., m:m + 1]
    pi = yi[..., :1] + yr[..., m:m + 1]
    return (torch.cat([pr, yr[..., 1:m]], dim=-1),
            torch.cat([pi, yi[..., 1:m]], dim=-1))


def rfft3d_planar(x, rad_z=None, rad_y=None, rad_x=None,
                  precision: str = DEFAULT_PRECISION, slab_rows: int = 0,
                  packed: bool = False, x_tile=None, out_scale: float = 1.0,
                  tables=None):
    """Full 3-D r2c of real (..., X, Y, N) float32: the r2c + y slab into a
    Z-padded packed intermediate, then the pitched x pass at M = N/2 lanes,
    whose tables carry ``out_scale``. Returns the packed (..., X, Y, M)
    pair with ``packed=True``, else the numpy (..., X, Y, M + 1) layout
    via ``unpack_rfft3d``. ``rad_z`` factors M."""
    m = x.shape[-1] // 2
    yr, yi = rfft_slab_yz(x, rad_y=rad_y, rad_z=rad_z, precision=precision,
                          zpad=_STRIDE_PAD, block_rows=slab_rows,
                          tables=tables)
    ty, tz = x_tile or (8, 128)
    yr, yi = fft_x_from_padded(yr, yi, m, radices=rad_x, precision=precision,
                               scale=out_scale, ty=ty, tz=tz, tables=tables)
    if packed:
        return yr, yi
    return unpack_rfft3d(yr, yi)


def irfft3d_planar(xr, xi, nz: int = 0, rad_z=None, rad_y=None, rad_x=None,
                   precision: str = DEFAULT_PRECISION, slab_rows: int = 0,
                   packed: bool = False, x_tile=None, out_scale: float = 1.0,
                   tables=None):
    """Full 3-D c2r of a planar half-spectrum, numpy layout (..., M + 1) or
    with ``packed=True`` the packed (..., M), to real (..., X, Y, N): the
    inverse x pass into a Z-padded intermediate, then the inverse y + c2r
    slab, whose re-tangle table carries out_scale / (X * Y * M). In the
    numpy layout the Nyquist plane takes an unscaled x inverse of its own
    and is injected into plane 0 inside the slab, so the M + 1 lanes are
    never carried past the x pass."""
    lanes = xr.shape[-1]
    m = lanes if packed else lanes - 1
    n = nz or 2 * m
    nx, ny = xr.shape[-3], xr.shape[-2]
    side_r = side_i = None
    if not packed:
        # the strided Nyquist lane, made contiguous: one X*Y plane
        side_r, side_i = fft_1d_planar(
            xr[..., m].contiguous(), xi[..., m].contiguous(), axis=-2,
            inverse=True, radices=rad_x, scale=False, precision=precision,
            tables=tables)
    ty, tz = x_tile or (8, 128)
    xr, xi = fft_x_to_padded(xr, xi, zpad=_STRIDE_PAD, inverse=True,
                             radices=rad_x, precision=precision,
                             z_true=0 if packed else m, ty=ty, tz=tz,
                             tables=tables)
    return irfft_slab_yz(xr, xi, n, rad_y=rad_y, rad_z=rad_z,
                         precision=precision,
                         scale=out_scale / (nx * ny * m),
                         block_rows=slab_rows, side_r=side_r, side_i=side_i,
                         tables=tables)
