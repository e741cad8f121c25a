"""The least time an H100 could take for a transform or a kernel: the
port's roofline, and the one count of each kernel's work.

Port of ``offt_tpu/bench/roofline.py``. ``fft3d_roofline`` keeps the
reference's terms where they carry over: device memory (each pass reads
and writes every local element) and the exchanges of a p1 x p2 mesh (two
all-to-all phases, each moving the share of the local volume that leaves
the rank's group). Both are data-sheet figures, so the result is a bound:
the fixed cost that each NCCL exchange pays on a host of four H100s
(``bench/mesh4.py``, 0.46-0.65 ms whatever its size) stands beside it in
``Roofline.exchange_fixed_s`` and is never added to it. The compute term
counts the transform's f32 operations by the port's convention, 5 n
log2(n) for a c2c of n points (2.5 n log2(n) for an r2c or c2r), at the
f32 rate of the CUDA cores; the reference counted the dense-DFT MACs its
MXU stages execute, which ``radix_sum`` still selects.

``kernel_work(name, shape)`` is the count of bytes and f32 operations
each kernel of the port must move and do at a shape, whatever implements
it (the kernel, its plain version or a library call), and
``kernel_bound`` the least time it follows; ``chip_smoke.py`` and the
benchmark read them. The names are the kernels of
``kernels.fused_fft.KERNELS``, the whole transforms ``c2c``, ``r2c`` and
``c2r`` (one read of the input, one write of the output) and the probe
``probe_mma`` of ``bench/probe_mxuwidth.py`` at its tiers
(``probe_mma:stack6``, ``probe_mma:3xtf32``, ``probe_mma:tf32``,
``probe_mma:fma``), whose operations run at their tier's peak.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """One card's published peaks (dense, at its full power limit)."""
    name: str
    hbm_gbps: float            # device memory, GB/s
    link_gbps: float           # NVLink, GB/s each way per card
    f32_tflops: float          # f32 FMA on the CUDA cores
    tf32_tflops: float         # tensor cores, TF32 inputs, f32 sums
    bf16_tflops: float         # tensor cores, bf16 inputs, f32 sums

    def peak_flops(self, kind: str = "f32") -> float:
        """Operations a second of ``kind``: "f32", "tf32" or "bf16"."""
        return {"f32": self.f32_tflops, "tf32": self.tf32_tflops,
                "bf16": self.bf16_tflops}[kind] * 1e12


# NVIDIA's H100 SXM data sheet (the figures PERF.md and chip_smoke.py use)
CHIPS = {
    "h100": ChipSpec("h100", hbm_gbps=3350.0, link_gbps=450.0,
                     f32_tflops=67.0, tf32_tflops=495.0,
                     bf16_tflops=989.0),
}

# measured fixed cost of one NCCL exchange on four H100s of one host
# (bench/mesh4.py, PERF.md section 5): beside the bound, never in it
EXCHANGE_FIXED_S = (0.46e-3, 0.65e-3)


@dataclasses.dataclass
class Roofline:
    t_hbm_s: float
    t_link_s: float
    t_flops_s: float
    exchanges: int = 0
    exchange_fixed_s: tuple = EXCHANGE_FIXED_S

    @property
    def t_bound_s(self) -> float:
        # each resource alone, perfectly overlapped: the largest
        return max(self.t_hbm_s, self.t_link_s, self.t_flops_s)

    @property
    def bound_by(self) -> str:
        return max((self.t_hbm_s, "bytes"), (self.t_link_s, "exchanges"),
                   (self.t_flops_s, "operations"))[1]

    def efficiency(self, measured_s: float) -> float:
        return self.t_bound_s / measured_s


def _chip(chip) -> ChipSpec:
    return CHIPS[chip] if isinstance(chip, str) else chip


def fft3d_roofline(
    shape: tuple[int, int, int],
    chip: ChipSpec | str = "h100",
    p1: int = 1,
    p2: int = 1,
    bytes_per_el: int = 8,          # complex64
    hbm_passes: float = 3.0,        # one read and write per axis pass
    radix_sum: float | None = None,  # MACs per element (sum of radices)
) -> Roofline:
    """Per-card least time of one 3-D c2c transform on a p1 x p2 mesh."""
    chip = _chip(chip)
    nx, ny, nz = shape
    total = nx * ny * nz
    p = p1 * p2
    local = total / p
    t_hbm = hbm_passes * 2 * local * bytes_per_el / (chip.hbm_gbps * 1e9)
    # two all-to-all phases; each moves (1 - 1/p_axis) of the local volume
    vol1 = local * bytes_per_el * (1 - 1 / p2) if p2 > 1 else 0.0
    vol2 = local * bytes_per_el * (1 - 1 / p1) if p1 > 1 else 0.0
    t_link = (vol1 + vol2) / (chip.link_gbps * 1e9) if p > 1 else 0.0
    if radix_sum is None:
        flops = local * 5 * math.log2(total)
    else:           # the reference's count: complex MACs of 8 real flops
        flops = local * radix_sum * 8
    t_flops = flops / chip.peak_flops("f32")
    return Roofline(t_hbm_s=t_hbm, t_link_s=t_link, t_flops_s=t_flops,
                    exchanges=(p2 > 1) + (p1 > 1))


# ---- the count of each kernel's work ------------------------------------

def fft_flops(n: int) -> float:
    """f32 operations per complex element of one length-n c2c, by the
    5 n log2(n) convention (the operations the transform needs, not what
    a dense-DFT core happens to execute)."""
    return 5 * math.log2(n)


def table_bytes(n: int) -> int:
    """Bytes of the length-n core table a kernel reads (its twiddle rows
    and stage roots)."""
    from ..kernels import tables as tb
    return 8 * (n + sum(tb.core_stages(tb._pick_stages(n))))


# each probe_mma tier (bench/probe_mxuwidth.py): the summed depth K of its
# products a lane and iteration, the operation type its peak reads, and
# the bytes of its table G (bf16 (128, 768) or f32 (128, 128))
MMA_TIERS = {"stack6": (6 * 128, "bf16", 128 * 768 * 2),
             "3xtf32": (3 * 128, "tf32", 128 * 128 * 4),
             "tf32": (128, "tf32", 128 * 128 * 4),
             "fma": (128, "f32", 128 * 128 * 4)}


def op_kind(name: str) -> str:
    """The operation type a kernel's work runs at: "f32" but for the
    tensor-core tiers of probe_mma."""
    if name.startswith("probe_mma:"):
        return MMA_TIERS[name.split(":", 1)[1]][1]
    return "f32"


def kernel_work(name: str, shape) -> tuple:
    """(bytes, operations) a kernel must move and do at ``shape``: each
    input read once (data and tables), each output written once; a
    length-n c2c at 5 n log2(n), an r2c or c2r at 2.5 n log2(n) (5 log2(n)
    per half-length element), the four-step twiddle at 6 flops, the
    untangle and re-tangle at 10 and 16 per output (``icrfft_last``: 16
    per real output). Shapes are the ones each kernel is timed at:
    ``fft_axis`` the x pass from a padded (X, Y, Z + 8), the real slabs'
    and ``assemble_mp1``'s as their wrappers take them; ``c2c`` /
    ``r2c`` / ``c2r`` the transform's real-space shape (a batch first),
    transformed over its last three axes (one axis for a 1-D shape);
    ``probe_mma:<tier>`` (B, L, R): B operands of (128, L) f32 through
    R products."""
    if name == "fft_last":
        b, n = shape
        e = b * n
        return 16 * e + table_bytes(n), e * fft_flops(n)
    if name == "fft_axis":                  # x from the padded (X, Y, Z+8)
        x, y, zp = shape
        e = x * y * (zp - 8)
        return 16 * e + table_bytes(x), e * fft_flops(x)
    if name == "fft_slab":
        p, y, z = shape
        e = p * y * z
        return (16 * e + table_bytes(y) + table_bytes(z),
                e * (fft_flops(z) + fft_flops(y)))
    if name == "rfft_slab":
        p, y, n = shape
        e = p * y * (n // 2)
        return (4 * p * y * n + 8 * e + table_bytes(y)
                + table_bytes(n // 2) + 4 * n,
                e * (fft_flops(n) + 10 + fft_flops(y)))
    if name == "irfft_slab":                # (P, Y, M + 8) -> (P, Y, 2M)
        p, y, mp = shape
        m = mp - 8
        e = p * y * m
        return (8 * e + 8 * p * y + 8 * e + table_bytes(y) + table_bytes(m)
                + 16 * m, e * (fft_flops(y) + 16 + fft_flops(2 * m)))
    if name == "assemble_mp1":
        p, y, m = shape
        return 8 * p * y * m + 16 * p * y + 8 * p * y * (m + 1), 0
    if name == "rfft_last":                 # numpy layout
        b, n = shape
        m = n // 2
        return (4 * b * n + 8 * b * (m + 1) + table_bytes(m) + 4 * n,
                b * m * (fft_flops(n) + 10))
    if name == "icrfft_last":               # packed (B, M) -> real (B, 2M)
        b, m = shape
        n = 2 * m
        return (8 * b * m + 4 * b * n + table_bytes(m) + 16 * m,
                b * (2.5 * n * math.log2(n) + 16 * n))
    if name == "step1_twiddle":
        b, n1, n2 = shape
        e = b * n1 * n2
        return (16 * e + 8 * n1 * n2 + table_bytes(n1),
                e * (fft_flops(n1) + 6))
    if name == "step3_transposed":
        b, n1, n2 = shape
        e = b * n1 * n2
        return 16 * e + table_bytes(n2), e * fft_flops(n2)
    if name == "fft_cube":                  # (B, X, Y, Z): one read, one write
        b, x, y, z = shape
        e = b * x * y * z
        tabs = table_bytes(x) + table_bytes(y)
        if z > 4096:    # the split z: the pair's tables and the twiddle
            from ..kernels import fourstep
            n1, n2 = fourstep.pick_split(z)
            tabs += table_bytes(n1) + table_bytes(n2) + 8 * z
        else:
            tabs += table_bytes(z)
        return (16 * e + tabs,
                e * (fft_flops(x) + fft_flops(y) + fft_flops(z)))
    if name in ("c2c", "r2c", "c2r"):
        dims = tuple(shape[-3:]) if len(shape) >= 3 else tuple(shape[-1:])
        n = math.prod(dims)
        batch = math.prod(shape) // n
        if name == "c2c":
            return 16 * n * batch, batch * n * fft_flops(n)
        half = math.prod(dims[:-1]) * (dims[-1] // 2 + 1)
        return (4 * n + 8 * half) * batch, batch * 2.5 * n * math.log2(n)
    if name.startswith("probe_mma:"):
        k, _, g = MMA_TIERS[name.split(":", 1)[1]]
        b, width, reps = shape
        return 8 * b * 128 * width + g, 2 * b * reps * 128 * k * width
    raise KeyError(name)


def kernel_bound(name: str, shape, chip: ChipSpec | str = "h100") -> tuple:
    """(least ms, "bytes" or "operations") of ``kernel_work(name, shape)``
    at the card's published peaks: the larger of its bytes over the
    memory rate and its operations over their type's rate."""
    chip = _chip(chip)
    nbytes, flops = kernel_work(name, shape)
    return roofline_ms(nbytes, flops, chip, op_kind(name))


def roofline_ms(nbytes: float, flops: float, chip: ChipSpec | str = "h100",
                kind: str = "f32") -> tuple:
    """(least ms, "bytes" or "operations") of moving ``nbytes`` and doing
    ``flops`` of ``kind`` on ``chip``."""
    chip = _chip(chip)
    tb_ms = nbytes / (chip.hbm_gbps * 1e9) * 1e3
    tf_ms = flops / chip.peak_flops(kind) * 1e3
    return (tb_ms, "bytes") if tb_ms >= tf_ms else (tf_ms, "operations")
