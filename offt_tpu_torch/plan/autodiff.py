"""Autodiff through plans: each calling convention is a
``torch.autograd.Function`` whose rules are other plans.

Port of ``offt_tpu/plan/autodiff.py``. A transform is linear, so its
vector-Jacobian product is its adjoint and its Jacobian-vector product is
the plan itself. In PyTorch's convention the gradient of a real loss
with respect to a complex tensor is dL/dRe + i dL/dIm, the conjugate of
``jax.grad``'s, and the backward of a C-linear y = A x is A^H applied to
the cotangent. On planar pairs the backward is the transpose of the real
map, which is the same A^H on the pair. So, with F the unnormalised DFT
and a the norm's scale:

- c2c, planar or complex: the adjoint of a F is a conj(F) = a G, the
  direction-flipped plan with the flipped norm (:func:`_flip_norm`),
  applied to the cotangent;
- r2c: the real part of the inverse c2c (flipped norm) of the cotangent
  zero-padded along z (:func:`zero_pad_z`). In the packed layout plane 0
  carries X_0 + i X_M, so its cotangent goes to bins 0 and M. On the
  distributed long-1-D engine's route, whose natural chunks the pad
  would change, the packed c2r plan of the halved cotangent instead
  (:func:`_vjp_r2c_packed`);
- c2r: the forward r2c (flipped norm) of the real cotangent, its interior
  bins doubled (each stands for itself and its conjugate mirror) and, in
  the numpy layout of even N, the pack transposed onto bins 0 and M
  (:func:`c2r_transpose`; the fold follows the c2r's untangle, which
  the fused and the unfused c2r write differently off the Hermitian
  manifold). Odd N has neither: bin 0 counts once and
  every other bin twice, the transpose of the Hermitian extension. A
  long-1-D rank weighs bin 0 once only where its chunk holds it.

Each rule runs plans through their own Functions, so a backward is itself
differentiable (grad of grad), and the adjoint plans are built once per
plan and kept (``Plan._related``), on the primal's params unless they are
infeasible for the adjoint, then at the default point. A mesh plan's real
stages need the whole z axis, which the transposed-out layout splits: its
adjoint is a pencil plan of the other direction whose z stage is the
1-D rule above (``z_adjoint``), where z-pencils hold z whole.

The reference wraps only its Pallas routes and differentiates the others
natively. The port wraps every route, the fp64 route and ``use_pallas=0``
included: the rules do not depend on the implementation, and the kernels
are opaque to autograd (ctypes launches on ``data_ptr``). Each Function
has ``setup_context``, a ``jvp`` (forward mode) and a ``vmap`` rule that
folds the mapped dim into the batch of a plan with one more batch dim, so
``torch.func`` transforms compose with the kernels on the card.
"""

from __future__ import annotations

import torch
from torch.autograd import forward_ad


def _flip_norm(norm):
    """The norm of the adjoint: the adjoint of a*F is a*G, and the
    direction-flipped plan with the complementary norm applies exactly
    a*G (ortho is unitary)."""
    if norm in (None, "backward"):
        return "forward"
    if norm == "forward":
        return "backward"
    return "ortho"


def zero_pad_z(ctr, cti, nz: int, packed: bool) -> tuple:
    """The full-length complex cotangent (planar) of a half-spectrum one:
    bins past the half are zero (the transpose of a half-spectrum map, not
    a Hermitian extension). Packed plane 0 carries X_0 + i X_M: its
    cotangent splits as ct'[0] = ct_P, ct'[M] = -i ct_P."""
    m = nz // 2
    lead = ctr.shape[:-1]
    if not packed:      # the numpy layout: bins land in place
        z = ctr.new_zeros(lead + (nz - ctr.shape[-1],))
        return torch.cat([ctr, z], -1), torch.cat([cti, z], -1)
    # -i (a + ib) = b - ia
    z = ctr.new_zeros(lead + (nz - m - 1,))
    return (torch.cat([ctr, cti[..., :1], z], -1),
            torch.cat([cti, -ctr[..., :1], z], -1))


def _half_weights(nf: int, nz: int, packed: bool, like,
                  bin0: bool = True) -> torch.Tensor:
    """Interior-bin doubling: every half-spectrum bin 1..ceil(N/2) - 1
    stands for itself and its conjugate mirror; the self-paired bins (0,
    and M when N is even, which the packed plane 0 also carries) count
    once. ``bin0=False``: the bins are a chunk that does not hold bin 0
    (a rank of the distributed long-1-D engine)."""
    w = like.new_full((nf,), 2.0)
    if bin0:
        w[0] = 1.0
    if not packed and nz % 2 == 0:
        w[-1] = 1.0
    return w


def c2r_transpose(vr, vi, nz: int, packed: bool, packs: bool,
                  bin0: bool = True) -> tuple:
    """The c2r's cotangent from the forward r2c (flipped norm) v of its
    real cotangent, along the last axis: interior bins doubled; odd N
    weighs bin 0 once and the others twice; the packed layout's plane 0
    once. In the numpy layout of even N, bins 0 and M transpose the c2r's
    untangle, which differs off the Hermitian manifold between the c2r
    implementations: ``packs`` for those that pack first, plane 0 :=
    X_0 + i X_M (the fused c2r, ``irfft3d_planar``), whose transpose puts
    p0 = v_0 + i v_M on bin 0; else ``rfft.irfft_1d``'s, which folds
    conj(X_M) into its first packed sample, v_0 - i v_M on bin 0. Both put
    v_M - i v_0 on bin M."""
    if packed or nz % 2:
        w = _half_weights(vr.shape[-1], nz, packed, vr, bin0)
        return vr * w, vi * w
    m = vr.shape[-1] - 1
    s = 1.0 if packs else -1.0
    return (torch.cat([vr[..., :1] - s * vi[..., m:], vr[..., 1:m] * 2.0,
                       vr[..., m:] + vi[..., :1]], -1),
            torch.cat([vi[..., :1] + s * vr[..., m:], vi[..., 1:m] * 2.0,
                       vi[..., m:] - vr[..., :1]], -1))


# ---- the rules, on planar cotangents --------------------------------------

def _owned(cts, p) -> tuple:
    """The cotangents as ``p`` may take them: contiguous (a gradient may
    be an expanded tensor), and copies where ``p`` writes its input
    (autograd may hand one gradient to several uses)."""
    if p.in_place:
        return tuple(c.clone(memory_format=torch.contiguous_format)
                     for c in cts)
    return tuple(c.contiguous() for c in cts)


def _swapped(plan):
    """The adjoint of a mesh real plan: the pencil plan of the other
    direction, flipped norm, with the 1-D rule as its z stage."""
    return plan._related(inverse=not plan.spec.inverse,
                         norm=_flip_norm(plan.norm), planar=True,
                         z_adjoint=not plan.z_adjoint)


def _stage_swapped(plan) -> bool:
    return plan.spec.real and plan.route == "pencil"


def _vjp_c2c(plan, *cts):
    """The flipped plan on the cotangent: a planar pair, or one complex
    tensor (torch may hand a conjugate view)."""
    p = plan._related(inverse=not plan.spec.inverse,
                      norm=_flip_norm(plan.norm))
    return p(*_owned([c.resolve_conj() for c in cts], p))


def _holds_bin0(plan) -> bool:
    """Whether this rank's half-spectrum block holds bin 0: every plan's
    but those of the long-1-D engine's ranks past the first (natural
    chunks)."""
    return plan.route != "long1d" or plan._long1d.me == 0


def _vjp_r2c_packed(plan, ctr, cti):
    """The packed r2c's transpose as the packed c2r plan (flipped norm) of
    the cotangent halved but at bin 0 (the c2r rule's weights inverted):
    R^T g = n C(w g) with w = 1 at bin 0 (DC + i Nyquist, each once) and
    1/2 elsewhere, C numpy's c2r, since n C(P)[j] = Re P_0 + Im P_0 (-1)^j
    + 2 Re sum_k P_k W_n^(-jk). The long-1-D engine's route: natural
    chunks in and out, where zero-padding the M bins to n (the
    reference's rule) would change every rank's chunk."""
    w = 1.0 / _half_weights(ctr.shape[-1], 0, True, ctr, _holds_bin0(plan))
    p = plan._related(inverse=True, norm=_flip_norm(plan.norm), planar=True)
    return p((ctr * w).contiguous(), (cti * w).contiguous())


def _vjp_r2c(plan, ctr, cti):
    """Real input cotangent of an r2c from its half-spectrum one."""
    if plan.route == "long1d":
        return _vjp_r2c_packed(plan, ctr, cti)
    if _stage_swapped(plan):
        return _swapped(plan)(ctr.contiguous(), cti.contiguous())
    p = plan._related(real=False, dtype=plan.spec.dtype, inverse=True,
                      norm=_flip_norm(plan.norm), planar=True, packed=False,
                      in_place=False)
    zr, _ = p(*zero_pad_z(ctr, cti, plan.spec.shape[2], plan.packed))
    return zr


def _vjp_c2r(plan, ct) -> tuple:
    """Planar half-spectrum cotangent of a c2r from its real one."""
    if _stage_swapped(plan):
        return _swapped(plan)(ct.contiguous())
    p = plan._related(inverse=False, norm=_flip_norm(plan.norm),
                      planar=True)
    vr, vi = p(ct.contiguous())
    return c2r_transpose(vr, vi, plan.spec.shape[2], plan.packed,
                         packs=plan.route == "rfft3d",
                         bin0=_holds_bin0(plan))


def _vjp_r2c_complex(plan, ct):
    return _vjp_r2c(plan, ct.real.contiguous(), ct.imag.contiguous())


def _vjp_c2r_complex(plan, ct):
    return torch.complex(*_vjp_c2r(plan, ct))


# ---- the Functions ---------------------------------------------------------

def _function(name: str, vjp) -> type:
    """A Function whose forward runs the plan's executable on the inputs
    and whose backward is ``vjp(plan, *cotangents)``."""

    def forward(plan, *xs):
        return plan._execute(xs)

    def setup_context(ctx, inputs, output):
        ctx.plan = inputs[0]
        if ctx.plan.in_place:
            ctx.mark_dirty(*inputs[1:])

    def backward(ctx, *cts):
        g = vjp(ctx.plan, *cts)
        return (None,) + (g if isinstance(g, tuple) else (g,))

    def jvp(ctx, _plan_tangent, *tangents):
        # a linear map's jvp is the map itself; a tangent that is not
        # there is zero
        like = [t for t in tangents if t is not None][0]
        ts = [torch.zeros_like(like) if t is None else t for t in tangents]
        return cls.apply(ctx.plan, *ts)

    def vmap(info, in_dims, plan, *xs):
        # the mapped dim joins the batch, after a sharded first batch dim
        pos = 1 if plan.spec.batch_sharded else 0
        moved = []
        for x, d in zip(xs, in_dims[1:]):
            if d is None:
                x = x.unsqueeze(pos).expand(
                    *x.shape[:pos], info.batch_size, *x.shape[pos:])
            else:
                x = x.movedim(d, pos)
            moved.append(x.contiguous())
        out = cls.apply(plan._batched(), *moved)
        return out, ((pos, pos) if isinstance(out, tuple) else pos)

    cls = type(torch.autograd.Function)(name, (torch.autograd.Function,), {
        "forward": staticmethod(forward),
        "setup_context": staticmethod(setup_context),
        "backward": staticmethod(backward),
        "jvp": staticmethod(jvp),
        "vmap": staticmethod(vmap),
        "__doc__": f"The plan's calling convention {name}; backward "
                   f"``{vjp.__name__}``.",
    })
    return cls


C2CPlanar = _function("C2CPlanar", _vjp_c2c)
R2CPlanar = _function("R2CPlanar", _vjp_r2c)
C2RPlanar = _function("C2RPlanar", _vjp_c2r)
C2CComplex = _function("C2CComplex", _vjp_c2c)
R2CComplex = _function("R2CComplex", _vjp_r2c_complex)
C2RComplex = _function("C2RComplex", _vjp_c2r_complex)


def tracked(xs) -> bool:
    """Whether a call on ``xs`` must run its Function: under a
    ``torch.func`` transform, in grad mode with an input that requires
    grad, or on a forward-mode dual input. Any other call runs the
    transform alone, without the Function's dispatch."""
    if torch._C._are_functorch_transforms_active():
        return True
    if torch.is_grad_enabled() and any(t.requires_grad for t in xs):
        return True
    return any(forward_ad.unpack_dual(t).tangent is not None for t in xs)


def function_of(plan) -> type:
    """The Function of ``plan``'s calling convention."""
    if not plan.spec.real:
        return C2CPlanar if plan.planar else C2CComplex
    if plan.spec.inverse:
        return C2RPlanar if plan.planar else C2RComplex
    return R2CPlanar if plan.planar else R2CComplex
