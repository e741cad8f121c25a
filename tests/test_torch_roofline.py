"""The port's roofline, ``offt_tpu_torch.bench.roofline``, against the
reference's ``offt_tpu.bench.roofline`` and against the bounds PERF.md's
kernel table (section 6) states."""

import math

import pytest

from offt_tpu.bench import roofline as ref
from offt_tpu_torch.bench import roofline as rl

H100 = rl.CHIPS["h100"]
# the reference's ChipSpec with the H100's figures: its exchange term
# serves a mesh axis with ici_gbps x (ici_links // 2), here one NVLink
# direction
REF_H100 = ref.ChipSpec("h100", hbm_gbps=H100.hbm_gbps,
                        ici_gbps=H100.link_gbps, ici_links=2,
                        bf16_tflops=H100.bf16_tflops)


def test_h100_figures():
    assert (H100.hbm_gbps, H100.link_gbps, H100.f32_tflops,
            H100.tf32_tflops, H100.bf16_tflops) == (3350, 450, 67, 495,
                                                    989)
    assert H100.peak_flops("bf16") == 989e12
    assert rl.EXCHANGE_FIXED_S == (0.46e-3, 0.65e-3)


@pytest.mark.parametrize("shape,p1,p2", [
    ((256, 256, 256), 1, 1), ((512, 512, 512), 2, 2),
    ((1024, 1024, 1024), 2, 4), ((256, 128, 64), 4, 1)])
def test_hbm_and_exchange_terms_equal_the_reference(shape, p1, p2):
    got = rl.fft3d_roofline(shape, H100, p1, p2)
    want = ref.fft3d_roofline(shape, REF_H100, p1, p2)
    assert got.t_hbm_s == pytest.approx(want.t_hbm_s, rel=1e-12)
    assert got.t_link_s == pytest.approx(want.t_ici_s, rel=1e-12)
    assert got.exchanges == (p1 > 1) + (p2 > 1)


@pytest.mark.parametrize("shape", [(256, 256, 256), (512, 512, 512)])
def test_compute_term_differs_by_design(shape):
    """The port counts the transform's 5 n log2(n) f32 operations at the
    CUDA cores' 67 TFLOP/s; the reference counts its dense stages' MACs
    (2 sqrt(N) an element an axis, 8 flops each) at a sixth of the MXU's
    bf16 rate. With ``radix_sum`` given the port keeps the reference's
    count, at its own f32 rate."""
    n = math.prod(shape)
    got = rl.fft3d_roofline(shape, H100)
    assert got.t_flops_s == pytest.approx(
        n * 5 * math.log2(n) / 67e12, rel=1e-12)
    want = ref.fft3d_roofline(shape, REF_H100)
    radix_sum = sum(2 * math.sqrt(s) for s in shape)
    assert want.t_mxu_s == pytest.approx(
        n * radix_sum * 8 / (989e12 / 6), rel=1e-12)
    assert got.t_flops_s != pytest.approx(want.t_mxu_s, rel=0.1)
    same = rl.fft3d_roofline(shape, H100, radix_sum=radix_sum)
    assert same.t_flops_s == pytest.approx(n * radix_sum * 8 / 67e12,
                                           rel=1e-12)


def test_the_exchange_cost_stays_beside_the_bound():
    r = rl.fft3d_roofline((256, 256, 256), H100, 2, 2)
    assert r.t_bound_s == max(r.t_hbm_s, r.t_link_s, r.t_flops_s)
    assert r.t_bound_s < rl.EXCHANGE_FIXED_S[0]
    assert r.exchange_fixed_s == rl.EXCHANGE_FIXED_S
    assert r.bound_by in ("bytes", "exchanges", "operations")


# PERF.md section 6's bound column (ms, bytes): kernel, shape, bound
PERF_BOUNDS = [
    ("fft_last", (65536, 1024), 0.3205),
    ("fft_last", (102400, 320), 0.1565),
    ("fft_slab", (256, 256, 256), 0.0801),
    ("fft_slab", (320, 320, 320), 0.1565),
    ("fft_axis", (256, 256, 264), 0.0801),
    ("rfft_slab", (256, 256, 256), 0.0401),
    ("irfft_slab", (256, 256, 136), 0.0402),
    ("assemble_mp1", (256, 256, 128), 0.0405),
    ("rfft_last", (65536, 256), 0.0402),
    ("icrfft_last", (65536, 128), 0.0401),
    ("step1_twiddle", (1, 1024, 1024), 0.0075),
    ("step3_transposed", (1, 1024, 1024), 0.0050),
    ("step1_twiddle", (1, 4096, 1024), 0.0301),
    ("step3_transposed", (1, 1024, 4096), 0.0200),
    ("fft_cube", (8, 128, 128, 128), 0.0801),
    ("fft_cube", (1, 8, 8, 32768), 0.0101),
]


@pytest.mark.parametrize("name,shape,bound", PERF_BOUNDS,
                         ids=[f"{n}-{'x'.join(map(str, s))}"
                              for n, s, _ in PERF_BOUNDS])
def test_kernel_bound_reproduces_perf_md(name, shape, bound):
    ms, by = rl.kernel_bound(name, shape)
    assert by == "bytes"
    assert round(ms, 4) == bound


def test_kernel_work_counts():
    b, f = rl.kernel_work("fft_last", (4, 16))
    assert b == 16 * 64 + rl.table_bytes(16) and f == 64 * 5 * 4
    # the whole transforms: one read of the input, one write of the output
    assert rl.kernel_work("c2c", (8, 8, 8)) == (16 * 512,
                                                512 * 5 * 9)
    assert rl.kernel_work("c2c", (2, 8, 8, 8))[0] == 2 * 16 * 512
    assert rl.kernel_work("c2c", (1024,)) == (16 * 1024, 1024 * 50)
    nb, nf = rl.kernel_work("r2c", (8, 8, 8))
    assert nb == 4 * 512 + 8 * 8 * 8 * 5 and nf == 2.5 * 512 * 9
    assert rl.kernel_work("c2r", (8, 8, 8)) == (nb, nf)
    with pytest.raises(KeyError):
        rl.kernel_work("no_such_kernel", (1,))


@pytest.mark.parametrize("tier,k,kind", [
    ("stack6", 768, "bf16"), ("3xtf32", 384, "tf32"), ("tf32", 128, "tf32"),
    ("fma", 128, "f32")])
def test_probe_mma_work_at_its_tier(tier, k, kind):
    """probe_mma's operations: 2 x 128 x K x L a product and operand, K
    the summed depth of the tier's products, at the tier's peak."""
    name = f"probe_mma:{tier}"
    assert rl.op_kind(name) == kind
    _, flops = rl.kernel_work(name, (132, 1024, 512))
    assert flops == 2 * 132 * 512 * 128 * k * 1024
    ms, by = rl.kernel_bound(name, (132, 1024, 512))
    assert by == "operations"
    assert ms == pytest.approx(flops / H100.peak_flops(kind) * 1e3)


def test_public_names_are_the_references():
    import offt_tpu.bench
    import offt_tpu_torch.bench
    assert set(offt_tpu.bench.__all__) <= set(offt_tpu_torch.bench.__all__)
    assert offt_tpu_torch.bench.CHIPS is rl.CHIPS
