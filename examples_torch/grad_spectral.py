"""Gradient-based spectral deconvolution through differentiable plans.

The port of examples/grad_spectral.py. A blurred, noisy observation
y = irfft3(H * rfft3(s_true)) + noise is inverted by gradient descent on
L(s) = ||blur(s) - y||^2 + lam * ||s||^2, differentiating end to end
through the r2c and c2r plans with ``torch.autograd``
(offt_tpu_torch/plan/autodiff.py): each backward runs the adjoint plan,
so every transform of the optimisation is one of the port's kernels.

Run:  python examples_torch/grad_spectral.py              (the card, 32^3)
      python examples_torch/grad_spectral.py --device cpu
      python examples_torch/grad_spectral.py --n 256       (256^3)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from _common import device, norm2, parser, real_pair, tensor

LAM = 1e-5      # the Tikhonov weight
LR = 0.45       # the gradient step
STEPS = 150


@dataclasses.dataclass
class Problem:
    blur: object        # s -> irfft3(H * rfft3(s))
    h: torch.Tensor     # the transfer function on the half-spectrum
    s_true: torch.Tensor
    y_obs: torch.Tensor

    def loss(self, s):
        r = self.blur(s) - self.y_obs
        return (r * r).sum() + LAM * (s * s).sum()

    def grad(self, s):
        """dL/ds at ``s``."""
        s = s.detach().requires_grad_()
        g, = torch.autograd.grad(self.loss(s), s)
        return g


def transfer(n: int) -> np.ndarray:
    """A Gaussian low-pass on the (n, n, n/2 + 1) half-spectrum; real and
    symmetric, so a filtered spectrum stays Hermitian-consistent."""
    k = [np.fft.fftfreq(n), np.fft.fftfreq(n), np.fft.rfftfreq(n)]
    k2 = (k[0][:, None, None] ** 2 + k[1][None, :, None] ** 2
          + k[2][None, None, :] ** 2)
    return np.exp(-k2 / (2 * 0.25 ** 2)).astype(np.float32)


def problem(n: int, dev, seed: int = 0) -> Problem:
    """The deconvolution problem at n^3 on ``dev`` from ``seed``."""
    fwd, inv = real_pair(n, dev)
    h = tensor(transfer(n), dev)

    def blur(s):
        yr, yi = fwd(s)
        return inv(yr * h, yi * h)

    rng = np.random.default_rng(seed)
    shape = (n, n, n)
    # a smooth (band-limited) source, so the blur is invertible in practice
    s_true = blur(tensor(rng.standard_normal(shape).astype(np.float32),
                         dev)) * 4.0
    y_obs = blur(s_true) + 0.001 * tensor(
        rng.standard_normal(shape).astype(np.float32), dev)
    return Problem(blur, h, s_true, y_obs)


def deconvolve(n: int, dev, steps: int = STEPS) -> dict:
    """The problem at n^3, then :func:`descend`."""
    return descend(problem(n, dev), steps)


def descend(pb: Problem, steps: int = STEPS) -> dict:
    """``steps`` of gradient descent from s = 0: the loss before and after
    and the recovered source's error against the true one."""
    s = torch.zeros_like(pb.s_true)
    with torch.no_grad():
        l0 = float(pb.loss(s))
    for _ in range(steps):
        s = s - LR * pb.grad(s)
    with torch.no_grad():
        l1 = float(pb.loss(s))
    err = (norm2(s - pb.s_true) / norm2(pb.s_true)) ** 0.5
    return {"l0": l0, "l1": l1, "err": err}


def main(argv=None) -> int:
    ns = parser(__doc__, n=32, steps=STEPS).parse_args(argv)
    r = deconvolve(ns.n, device(ns.device), ns.steps)
    print(f"loss {r['l0']:.2f} -> {r['l1']:.5f}; recovered rel err "
          f"{r['err']:.3f}")
    assert r["l1"] < 0.01 * r["l0"] and r["err"] < 0.25, r
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
