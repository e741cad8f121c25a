"""Autodiff through offt_tpu_torch's c2c plans held against offt_tpu's,
case by case after tests/test_autodiff.py.

The same numpy inputs from a seed go through ``jax.vjp`` / ``jax.jvp`` /
``jax.grad`` of the reference plan (its Pallas kernels in interpret mode
on the port's resolved parameters where the plan is complex64, its native
autodiff on the fp64 route) and through ``torch.autograd.grad`` /
``torch.func`` of the port's plan. Tolerances: 1e-5 relative at complex64
(tests/test_autodiff.py's), 1e-10 on the fp64 route.

Conventions: the planar (re, im) pairs compare directly. PyTorch's
gradient of a real loss in a complex tensor is the conjugate of JAX's, so
the complex calling convention compares through the conjugate: a torch
vjp of ``ct`` is conj of the reference's vjp of conj(ct). The transpose
identity in torch reads Re<ct, f(v)> == Re<vjp(ct), v> with no
conjugated leaves, over fuzzed cotangents with a seed per leaf.

The port wraps every route in its Functions (``plan/autodiff.py``), the
fp64 route and ``use_pallas=0`` too; these tests check that a gradient
ran the Function's rule (its ``grad_fn`` type and the adjoint plan's
calls), not autograd through the plain versions' torch ops."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import offt_tpu
import offt_tpu_torch as ot
from offt_tpu.plan.params import PlanParams as RefParams
from offt_tpu_torch.plan import api, autodiff
from offt_tpu_torch.plan.params import PlanParams

TOL = 1e-5      # relative, complex64
TOL64 = 1e-10   # the fp64 route


def rand(shape, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def randc(shape, seed, dtype=np.complex128):
    r = np.random.default_rng(seed)
    return (r.standard_normal(shape)
            + 1j * r.standard_normal(shape)).astype(dtype)


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm((a - b).ravel())
                 / np.linalg.norm(b.ravel()))


def t(a, grad=False):
    x = torch.from_numpy(np.ascontiguousarray(a))
    return x.requires_grad_() if grad else x


def ref_plan(p, **kw):
    """The reference plan of the port's plan ``p`` on its resolved
    parameters (``params=None``: the reference's own default point)."""
    params = kw.pop("params", "same")
    if params == "same":
        params = RefParams(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in
                              dataclasses.asdict(p.params).items()})
    s = p.spec
    return offt_tpu.plan(s.shape, s.dtype, real=s.real, inverse=s.inverse,
                         planar=p.planar, packed=p.packed, norm=p.norm,
                         batch_dims=p.ndim - 3, params=params,
                         use_cache=False, **kw)


def port_vjp(p, args, cts):
    """The port's input cotangents of ``cts`` at the numpy ``args``."""
    xs = [t(a, grad=True) for a in args]
    y = p(*xs)
    ys = y if isinstance(y, tuple) else (y,)
    gs = torch.autograd.grad(ys, xs, [t(c) for c in cts])
    return [g.numpy() for g in gs], ys


def ref_vjp(rp, args, cts, planar: bool):
    """The reference's input cotangents in torch's convention: the planar
    pair directly, complex leaves through the conjugate."""
    if planar and len(args) == 2:
        y, vjp = jax.vjp(lambda a, b: rp((a, b)), *map(jnp.asarray, args))
    else:
        y, vjp = jax.vjp(rp, *map(jnp.asarray, args))
    ct = tuple(jnp.asarray(np.conj(c)) for c in cts)
    g = vjp(ct if isinstance(y, tuple) else ct[0])
    return [np.conj(np.asarray(a)) for a in g]


def fuzz_cts(ys, seed: int) -> list:
    """A random cotangent per output leaf, each from its own seed (one
    seed for both would hide a crossed re/im)."""
    out = []
    for i, y in enumerate(ys):
        shp, dt = tuple(y.shape), y.detach().numpy().dtype
        out.append(randc(shp, seed + i, dt) if y.is_complex()
                   else rand(shp, seed + i, dt))
    return out


def check_transpose(p, args, seed: int, tol: float):
    """Re<ct, p(v)> == Re<vjp(ct), v> over fuzzed cotangents; returns the
    cotangents and the port's vjp of them."""
    xs = [t(a, grad=True) for a in args]
    y = p(*xs)
    ys = y if isinstance(y, tuple) else (y,)
    cts = fuzz_cts(ys, seed)
    gs = torch.autograd.grad(ys, xs, [t(c) for c in cts])

    def pair(a, b):
        return float(np.real(np.vdot(np.asarray(a), np.asarray(b))))
    lhs = sum(pair(c, yy.detach().numpy()) for c, yy in zip(cts, ys))
    rhs = sum(pair(g.numpy(), a) for g, a in zip(gs, args))
    assert abs(lhs - rhs) <= tol * abs(lhs), (lhs, rhs)
    return cts, [g.numpy() for g in gs]


# ---- gradients of a real loss against the reference's ---------------------

@pytest.mark.parametrize("norm", ["backward", "ortho", "forward"])
@pytest.mark.parametrize("inverse", [False, True])
def test_grad_c2c_matches_reference(norm, inverse):
    """complex128 (the fp64 route): torch's gradient is conj(jax.grad)."""
    x, w = randc((8, 8, 8), 0), randc((8, 8, 8), 1)
    p = ot.plan((8, 8, 8), "complex128", inverse=inverse, norm=norm,
                device="cpu")
    rp = offt_tpu.plan((8, 8, 8), "complex128", inverse=inverse, norm=norm)
    xt = t(x, grad=True)
    g, = torch.autograd.grad((p(xt) * t(w)).abs().pow(2).sum(), xt)
    gj = jax.grad(lambda z: jnp.sum(jnp.abs(rp(z) * w) ** 2))(jnp.asarray(x))
    assert rel(g.numpy(), np.conj(np.asarray(gj))) < TOL64
    # and torch.fft's own rule on the same loss
    f = torch.fft.ifftn if inverse else torch.fft.fftn
    xt2 = t(x, grad=True)
    g2, = torch.autograd.grad((f(xt2, norm=norm) * t(w)).abs().pow(2).sum(),
                              xt2)
    assert rel(g.numpy(), g2.numpy()) < TOL64


@pytest.mark.parametrize("inverse", [False, True])
def test_grad_c2c_complex64_matches_reference(inverse):
    """complex64 on the kernel route against the reference's linear_call
    rule on its Pallas kernels (interpret mode), same parameters."""
    x = randc((8, 8, 8), 2, np.complex64)
    w = rand((8, 8, 8), 3, np.float32)
    p = ot.plan((8, 8, 8), "complex64", inverse=inverse, norm="ortho",
                device="cpu")
    assert p.route == "fft3d"
    rp = ref_plan(p)
    xt = t(x, grad=True)
    g, = torch.autograd.grad((t(w) * p(xt).abs().pow(2)).sum(), xt)
    gj = jax.grad(lambda z: jnp.sum(w * jnp.abs(rp(z)) ** 2))(
        jnp.asarray(x))
    assert rel(g.numpy(), np.conj(np.asarray(gj))) < TOL


# ---- the transpose identity and the vjp against the reference's -----------

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("norm", ["backward", "ortho", "forward"])
def test_transpose_c2c_planar(inverse, norm):
    p = ot.plan((16, 8, 8), "complex64", inverse=inverse, norm=norm,
                planar=True, device="cpu")
    args = (rand((16, 8, 8), 8, np.float32), rand((16, 8, 8), 9, np.float32))
    cts, g = check_transpose(p, args, seed=10, tol=1e-5)
    gr = ref_vjp(ref_plan(p), args, cts, planar=True)
    for a, b in zip(g, gr):
        assert rel(a, b) < TOL


@pytest.mark.parametrize("trial", range(5))
def test_fuzz_transpose_c2c(trial):
    """Random shapes x direction x norm x calling convention (the
    reference's test_fuzz_transpose_wrapped_c64, on the port alone: the
    identity holds for any correct vjp)."""
    rng = np.random.default_rng(4200 + trial)
    shape = tuple(int(rng.choice([8, 16, 24, 32, 64])) for _ in range(3))
    inverse = bool(rng.integers(0, 2))
    norm = [None, "ortho", "forward"][int(rng.integers(0, 3))]
    planar = bool(rng.integers(0, 2))
    p = ot.plan(shape, "complex64", inverse=inverse, norm=norm,
                planar=planar, device="cpu")
    if planar:
        args = (rand(shape, 100 + trial, np.float32),
                rand(shape, 200 + trial, np.float32))
    else:
        args = (randc(shape, 100 + trial, np.complex64),)
    check_transpose(p, args, seed=300 + trial, tol=1e-4)


# ---- forward mode, grad of grad, vmap -------------------------------------

def test_jvp_planar_c2c():
    p = ot.plan((16, 8, 8), "complex64", planar=True, device="cpu")
    re, im, tr, ti = (rand((16, 8, 8), s, np.float32) for s in range(51, 55))
    _, (yr, yi) = torch.func.jvp(lambda a, b: p(a, b), (t(re), t(im)),
                                 (t(tr), t(ti)))
    got = yr.numpy() + 1j * yi.numpy()
    assert rel(got, np.fft.fftn(tr + 1j * ti.astype(np.float64))) < TOL
    rp = ref_plan(p)
    _, (rr, ri) = jax.jvp(lambda a, b: rp((a, b)), (re, im), (tr, ti))
    assert rel(got, np.asarray(rr) + 1j * np.asarray(ri)) < TOL
    # and the forward-AD API
    from torch.autograd import forward_ad as fw
    with fw.dual_level():
        yr2, yi2 = p(fw.make_dual(t(re), t(tr)), fw.make_dual(t(im), t(ti)))
        d = fw.unpack_dual(yr2).tangent.numpy() + \
            1j * fw.unpack_dual(yi2).tangent.numpy()
    assert rel(d, got) < TOL


def test_jvp_complex_c2c_and_grad_of_grad():
    """The reference's linear_call case: jvp, then second-order AD
    through ``create_graph`` and through ``torch.func.grad``."""
    pc = ot.plan((8, 8, 8), "complex64", device="cpu")
    x, tx = randc((8, 8, 8), 55, np.complex64), randc((8, 8, 8), 56,
                                                       np.complex64)
    _, tv = torch.func.jvp(pc, (t(x),), (t(tx),))
    assert rel(tv.numpy(), np.fft.fftn(tx.astype(np.complex128))) < TOL
    rp = ref_plan(pc)
    _, tr = jax.jvp(rp, (jnp.asarray(x),), (jnp.asarray(tx),))
    assert rel(tv.numpy(), np.asarray(tr)) < TOL

    def loss(v):
        return pc(v).abs().pow(2).sum()

    def meta(v):
        return torch.func.grad(loss)(v).abs().pow(2).sum()
    h = torch.func.grad(meta)(t(x))
    hj = jax.grad(lambda v: jnp.sum(jnp.abs(jax.grad(
        lambda u: jnp.sum(jnp.abs(rp(u)) ** 2))(v)) ** 2))(jnp.asarray(x))
    assert rel(h.numpy(), np.conj(np.asarray(hj))) < TOL
    xt = t(x, grad=True)
    g, = torch.autograd.grad(loss(xt), xt, create_graph=True)
    assert type(g.grad_fn).__name__ == "C2CComplexBackward"
    h2, = torch.autograd.grad(g.abs().pow(2).sum(), xt)
    assert rel(h2.numpy(), h.numpy()) < TOL


def test_vmap_and_vmap_of_grad():
    """``torch.func.vmap`` (the mapped dim folded into a batched plan
    from the one-shot cache) and vmap of grad, against the reference's
    jax.vmap of grad; a mapped dim that is not the first, and an unmapped input
    (expanded over the batch)."""
    p = ot.plan((8, 8, 8), "complex64", planar=True, device="cpu")
    re, im = rand((3, 8, 8, 8), 71, np.float32), rand((3, 8, 8, 8), 72,
                                                       np.float32)
    yr, yi = torch.func.vmap(lambda a, b: p(a, b))(t(re), t(im))
    got = yr.numpy() + 1j * yi.numpy()
    assert rel(got, np.fft.fftn(re + 1j * im.astype(np.float64),
                                axes=(-3, -2, -1))) < TOL
    assert p._batched() is p._batched() and p._batched().ndim == 4
    # the reference's linear_call has no batching rule: its vmap of grad
    # runs at its own default point (native autodiff, no Pallas)
    rp = ref_plan(p, params=None)

    def loss_t(a, b):
        return p(a, b)[0].pow(2).sum()
    g = torch.func.vmap(torch.func.grad(loss_t))(t(re), t(im))
    gj = jax.vmap(jax.grad(lambda a, b: jnp.sum(rp((a, b))[0] ** 2)))(
        jnp.asarray(re), jnp.asarray(im))
    assert g.shape == (3, 8, 8, 8) and rel(g.numpy(), np.asarray(gj)) < TOL
    y2r, _ = torch.func.vmap(lambda a, b: p(a, b), in_dims=(1, None))(
        t(np.ascontiguousarray(re.transpose(1, 0, 2, 3))), t(im[0]))
    want = np.fft.fftn(re + 1j * im[:1].astype(np.float64),
                       axes=(-3, -2, -1)).real
    assert rel(y2r.numpy(), want) < TOL


# ---- the routes the Function wraps ----------------------------------------

@pytest.mark.parametrize("dtype,params", [
    ("complex64", None), ("complex128", None),
    ("complex64", PlanParams(use_pallas=0))])
def test_every_route_runs_the_functions_rule(dtype, params, monkeypatch):
    """The port wraps every route in one Function per calling convention,
    the fp64 route and use_pallas=0 included (the reference
    differentiates those natively): the gradient's node is the Function's
    and the backward ran the adjoint plan, the direction-flipped plan
    with the flipped norm, built once and kept."""
    p = ot.plan((8, 8, 8), dtype, planar=True, norm="forward", params=params,
                device="cpu")
    rdt = np.float64 if dtype == "complex128" else np.float32
    xr, xi = t(rand((8, 8, 8), 1, rdt), True), t(rand((8, 8, 8), 2, rdt),
                                                 True)
    yr, yi = p(xr, xi)
    assert type(yr.grad_fn).__name__ == "C2CPlanarBackward"
    runs = []
    adj = p._related(inverse=True, norm="backward")
    monkeypatch.setattr(adj, "_execute",
                        lambda xs, f=adj._execute: runs.append(1) or f(xs))
    gr, gi = torch.autograd.grad(yr.sum() + 2 * yi.sum(), (xr, xi))
    assert runs == [1] and adj.spec.inverse and adj.norm == "backward"
    assert adj.params == p.params and adj.device == p.device
    assert p._related(inverse=True, norm="backward") is adj
    # the adjoint of F / N (norm "forward") is G / N, the inverse of
    # norm "backward"
    ct = torch.complex(torch.ones(8, 8, 8, dtype=yr.dtype),
                       2 * torch.ones(8, 8, 8, dtype=yr.dtype))
    want = torch.fft.ifftn(ct.to(torch.complex128), norm="backward")
    got = torch.complex(gr, gi).to(torch.complex128)
    assert rel(got.numpy(), want.numpy()) < (TOL64 if rdt == np.float64
                                             else TOL)
    for planar, name in ((False, "C2CComplexBackward"),):
        pc = ot.plan((8, 8, 8), dtype, planar=planar, device="cpu")
        z = t(randc((8, 8, 8), 3, np.complex128 if rdt == np.float64
                    else np.complex64), True)
        assert type(pc(z).grad_fn).__name__ == name


@pytest.mark.parametrize("planar", [True, False])
def test_untracked_calls_skip_the_function(planar, monkeypatch):
    """A call that nothing differentiates (no input requires grad, or
    grad mode off) runs the transform alone, without the Function's
    dispatch; an input that requires grad, a forward-mode dual input and
    a torch.func transform run the Function, with the same values."""
    p = ot.plan((4, 8, 16), "complex64", planar=planar, device="cpu")
    applied = []
    of = autodiff.function_of
    monkeypatch.setattr(autodiff, "function_of",
                        lambda plan: applied.append(1) or of(plan))
    z = randc((4, 8, 16), 31, np.complex64)
    dz = randc((4, 8, 16), 32, np.complex64)
    xs = (t(z.real.copy()), t(z.imag.copy())) if planar else (t(z),)
    dxs = (t(dz.real.copy()), t(dz.imag.copy())) if planar else (t(dz),)

    def values(y):
        return y if planar else (y,)
    want = values(p(*xs))
    with torch.no_grad():
        values(p(*(x.clone().requires_grad_() for x in xs)))
    assert applied == [] and want[0].grad_fn is None
    got = values(p(*(x.clone().requires_grad_() for x in xs)))
    assert len(applied) == 1 and got[0].grad_fn is not None
    from torch.autograd import forward_ad
    with forward_ad.dual_level():
        duals = [forward_ad.make_dual(x, d) for x, d in zip(xs, dxs)]
        fw = values(p(*duals))
        tangent = forward_ad.unpack_dual(fw[0]).tangent
    assert len(applied) == 2 and tangent is not None
    _, jt = torch.func.jvp(lambda *a: values(p(*a)), xs, dxs)
    assert len(applied) >= 3
    for a, b in zip(got, want):
        assert torch.equal(a.detach(), b)
    for a, b in zip([forward_ad.unpack_dual(f).primal for f in fw], want):
        assert torch.equal(a, b)
    assert torch.equal(tangent, jt[0])
    assert torch.equal(jt[0], values(p(*dxs))[0])


def test_adjoint_plan_falls_back_to_the_default_point(monkeypatch):
    """The reference's retry: where the primal's params are infeasible for
    the adjoint plan, it is built at the cache and default point."""
    p = ot.plan((8, 8, 8), "complex64", planar=True, device="cpu",
                params=PlanParams(use_pallas=1, block_batch=4))
    build = api._build
    seen = []

    def picky(shape, dtype, **kw):
        seen.append(kw.get("params"))
        if kw.get("inverse") and kw.get("params") is not None:
            raise ValueError("infeasible plan: test")
        return build(shape, dtype, **kw)
    monkeypatch.setattr(api, "_build", picky)
    adj = p._related(inverse=True, norm="forward")
    assert seen == [p.params, None]
    assert adj.params != p.params and adj.spec.inverse


# ---- in place and donate under autograd -----------------------------------

@pytest.mark.parametrize("how", ["in_place", "donate"])
def test_in_place_and_donate_under_autograd(how):
    """A plan that writes its inputs (in_place=True, or donate=True on the
    planar c2c kernel route) marks them modified: on a non-leaf the
    gradient flows (the adjoint plan runs in place too, on a copy of the
    cotangent), on a leaf that requires grad torch raises its own
    error."""
    p = ot.plan((8, 8, 8), "complex64", planar=True, device="cpu",
                **{how: True})
    q = ot.plan((8, 8, 8), "complex64", planar=True, device="cpu")
    assert p.in_place and not q.in_place
    a = t(rand((8, 8, 8), 4, np.float32), True)
    b = t(rand((8, 8, 8), 5, np.float32), True)
    with pytest.raises(RuntimeError, match="leaf Variable"):
        p(a, b)
    a2, b2 = a * 1.0, b * 1.0
    yr, yi = p(a2, b2)
    assert yr is a2 and yi is b2        # the inputs hold the result
    assert p._related(inverse=True, norm="forward").in_place
    ga, gb = torch.autograd.grad(yr.pow(2).sum() + yi.sum(), (a, b))
    zr, zi = q(a, b)
    ha, hb = torch.autograd.grad(zr.pow(2).sum() + zi.sum(), (a, b))
    assert rel(ga.numpy(), ha.numpy()) < TOL
    assert rel(gb.numpy(), hb.numpy()) < TOL
    assert torch.equal(yr.detach(), zr.detach())
