"""The H100 probes of the reference's last two v5e probes on the CPU:
``bench/probe_mxuwidth.py`` (the plain versions of ``probe_mma``'s
variants against a jax.numpy transcription of the reference's ``step``,
``docs/receipts/probe_mxuwidth.py:54-66``, which is local to its
``main()`` and cannot be imported; each tier's emulation; the error rows'
order) and ``bench/probe_ryconcat.py`` (the function it times, the r2c
slab, against the reference's ``pallas_fft.rfft_slab_yz`` in interpret
mode and against numpy on the interior bins, as the reference probe
checks; the new cost-probe codes refused off the card). The kernels'
own tests run on the card (tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from offt_tpu.kernels import pallas_fft as pf
from offt_tpu_torch.bench import probe_mxuwidth as pm
from offt_tpu_torch.bench import probe_ryconcat as pr
from offt_tpu_torch.kernels import fused_fft as ff

# one stage product: exact bf16 / TF32 products, f32 sums in another
# order (XLA's dot against torch's matmul): a few ulps of the largest
# output
TOL_STEP = 2e-6
# four chained iterations: the 3-word split of slightly different
# values (each side's f32 sums) round apart, and with the stacked table
# the six terms still sum to the f32 product (2^-24 a word boundary)
TOL_CHAIN = 1e-5


def _split3(x):
    x0 = x.astype(jnp.bfloat16)
    r = x - x0.astype(jnp.float32)
    x1 = r.astype(jnp.bfloat16)
    x2 = (r - x1.astype(jnp.float32)).astype(jnp.bfloat16)
    return x0, x1, x2


def ref_step(mode, gcat, acc):
    """The reference kern's step (probe_mxuwidth.py:54-66), one operand."""
    gs = [gcat[:, k * 128:(k + 1) * 128] for k in range(6)]
    x0, x1, x2 = _split3(acc)
    if mode == "concat":
        xc = jnp.concatenate([x0, x1, x2, x0, x1, x0], axis=0)
        y = jnp.dot(gcat, xc, preferred_element_type=jnp.float32)
    else:
        ps = [jnp.dot(gs[k], w, preferred_element_type=jnp.float32)
              for k, w in enumerate((x0, x1, x2, x0, x1, x0))]
        y = ps[0] + ps[1] + ps[2] + ps[3] + ps[4] + ps[5]
    return y + acc * 0.25


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("variant,mode", [("stack6", "concat"),
                                          ("stack6-six", "six")])
@pytest.mark.parametrize("lanes", [128, 256])
def test_stack6_plain_matches_the_reference_step(variant, mode, lanes):
    rng = np.random.default_rng(lanes)
    x = rng.standard_normal((128, lanes)).astype(np.float32)
    g = jnp.asarray((rng.standard_normal((128, 768)) * 2e-3)
                    .astype(np.float32)).astype(jnp.bfloat16)
    want = ref_step(mode, g, jnp.asarray(x))
    gt = torch.from_numpy(np.array(g.astype(jnp.float32))).to(
        torch.bfloat16)
    got = pm.probe_mma(torch.from_numpy(x)[None], gt, 1, variant)
    assert got.shape == (1, 128, lanes)
    assert _max_rel(got[0], want) < TOL_STEP


@pytest.mark.parametrize("variant,mode", [("stack6", "concat"),
                                          ("stack6-six", "six")])
def test_stack6_chain_matches_the_reference(variant, mode):
    """Four dependent iterations with the stacked table of an f32 G (the
    construct as the reference's kernels use it)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((128, 128)).astype(np.float32)
    t = torch.from_numpy((rng.standard_normal((128, 128)) * 0.05)
                         .astype(np.float32))
    gt = pm.stack_table(t)
    g = jnp.asarray(gt.float().numpy()).astype(jnp.bfloat16)
    want = jnp.asarray(x)
    for _ in range(4):
        want = ref_step(mode, g, want)
    got = pm.probe_mma(torch.from_numpy(x)[None], gt, 4, variant)
    assert _max_rel(got[0], want) < TOL_CHAIN
    # and the six terms stand for the f32 product
    f32 = torch.from_numpy(x)
    for _ in range(4):
        f32 = (t.double() @ f32.double() + 0.25 * f32.double()).float()
    assert _max_rel(got[0], f32) < TOL_CHAIN


def test_tier_emulations():
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    t = pm.tf32(a)
    assert (t.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((a - t).abs() <= a.abs() * 2.0 ** -10).all()
    assert torch.equal(pm.tf32(t), t)
    x0, x1, x2 = pm.split3(a)
    for w in (x0, x1, x2):
        assert torch.equal(w.to(torch.bfloat16).float(), w)
    err = (x0.double() + x1.double() + x2.double() - a.double()).abs()
    assert (err <= a.abs().double() * 2.0 ** -24).all()
    g = pm.stack_table(a.repeat(4).view(128, 128))
    assert g.dtype == torch.bfloat16 and g.shape == (128, 768)
    assert torch.equal(g[:, :128], g[:, 128:256])
    assert torch.equal(g[:, :128], g[:, 256:384])
    assert torch.equal(g[:, 384:512], g[:, 512:640])


@pytest.mark.parametrize("variant", ["3xtf32", "tf32", "fma"])
def test_tf32_and_fma_plain_against_float64(variant):
    """One iteration of each f32-table variant against the f64 product of
    its own inputs: fma and 3xtf32 within f32 rounding, tf32 within its
    10-bit mantissa."""
    x, g = pm.inputs(variant, 2, 128, "cpu", seed=3)
    got = pm.probe_mma(x, g, 1, variant, 0.0)
    want = (g.double() @ x.double())
    tol = 3e-3 if variant == "tf32" else 2e-6
    assert _max_rel(got, want) < tol


def test_accuracy_rows_order():
    """Each variant's error on one stage product of a 128-point DFT
    against float64, the largest of the draws, by the plain versions: a
    lower bound on the card's error (their products are exact and their
    sums plain f32; the tensor cores' accumulator truncates at its
    alignment on top), not a model of it. Their order holds on the card
    too: tf32 far above the 1e-6 bar, 3xtf32 about fma, the stacked bf16
    words no worse than these; and no plain reading above the variant's
    card ceiling."""
    rows = {r["variant"]: r for r in pm.accuracy_rows("cpu")}
    assert set(rows) == set(pm.VARIANTS)
    err = {v: r["rel_err"] for v, r in rows.items()}
    assert all(r["draws"] == len(pm.SEEDS) * len(pm.WIDTHS)
               for r in rows.values())
    assert err["tf32"] > 1e-4 > 100 * err["3xtf32"]
    assert 0.1 < err["3xtf32"] / err["fma"] < 10
    assert err["fma"] < 1e-6
    assert err["stack6-six"] <= err["fma"] and err["stack6"] < 1e-6
    for v in pm.VARIANTS:
        assert err[v] <= pm.CEILING[v], v


def test_probe_mma_wrapper_checks_and_counts():
    x, g = pm.inputs("stack6", 1, 128, "cpu")
    pm.reset_counts()
    pm.probe_mma(x, g, 2, "stack6")
    assert pm.probe_mma.plain_calls == 1
    assert sum(pm.probe_mma.launches.values()) == 0
    with pytest.raises(ValueError, match="variant"):
        pm.probe_mma(x, g, 1, "stack3")
    with pytest.raises(ValueError, match="takes G"):
        pm.probe_mma(x, g.float(), 1, "stack6")
    with pytest.raises(ValueError, match="takes G"):
        pm.probe_mma(x, g, 1, "tf32")
    with pytest.raises(ValueError, match="multiple of 128"):
        pm.probe_mma(torch.zeros((1, 128, 96)), g, 1, "stack6")
    with pytest.raises(ValueError, match="float32"):
        pm.probe_mma(torch.zeros((1, 64, 128)), g, 1, "stack6")
    with pytest.raises(ValueError, match="contiguous"):
        pm.probe_mma(torch.zeros((1, 256, 128)).transpose(1, 2)[:, :128],
                     g, 1, "stack6")
    assert torch.equal(pm.probe_mma(x, g, 0, "stack6"), x)


@pytest.mark.parametrize("shape", [(2, 16, 256), (2, 32, 512)])
def test_ryconcat_function_matches_the_reference(shape):
    """The function probe_ryconcat times, the r2c slab (rfft along z,
    packed, then fft along y), by its plain version against the
    reference's rfft_slab_yz in interpret mode, and against numpy on the
    interior bins k = 1 .. M - 1 (the reference probe's check)."""
    x = np.random.default_rng(sum(shape)).standard_normal(shape) \
        .astype(np.float32)
    m = shape[-1] // 2
    got = ff.rfft_slab_yz.plain(torch.from_numpy(x), zpad=8)
    ref = pf.rfft_slab_yz(jnp.asarray(x), zpad=8)
    assert got[0].shape == ref[0].shape == (*shape[:-1], m + 8)
    g = got[0][..., :m].double().numpy() + 1j * got[1][..., :m].double() \
        .numpy()
    r = np.asarray(ref[0])[..., :m] + 1j * np.asarray(ref[1])[..., :m]
    assert np.abs(g - r).max() / np.abs(r).max() < 1e-6
    assert pr.interior_error(torch.from_numpy(x), got) < 1e-6
    want = np.fft.fft(np.fft.rfft(x.astype(np.float64), axis=2), axis=1)
    assert np.allclose(g[..., 0], want[..., 0] + 1j * want[..., m],
                       rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("code", pr.CODES)
def test_ryconcat_codes_refuse_the_plain_version(code):
    """The wider-tile codes exist only in the register-core kernel: a CPU
    tensor (the plain version) raises, as the other cost probes do."""
    assert code in ff._RSLAB_PHASES and ff._RSLAB_PHASES[code] > 4
    with pytest.raises(ValueError, match="phases"):
        ff.rfft_slab_yz(torch.zeros((1, 512, 512)), phases=code)
