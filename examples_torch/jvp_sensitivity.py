"""Forward-mode sensitivity through plans.

The port of examples/jvp_sensitivity.py. A spectral diffusion solve
u(t) = irfft3(exp(-nu |k|^2 t) * rfft3(u0)) is differentiated with
``torch.func.jacfwd`` with respect to a few physical parameters
(nu, t): forward mode costs one jvp pass per parameter whatever the
size of the output (a whole 3-D field), where reverse mode would need
one vjp per output element. The plans carry ``jvp`` and ``vmap`` rules
(offt_tpu_torch/plan/autodiff.py: the jvp of the linear FFT is the FFT,
a vmapped call is a plan with one more batch dim), so the tangents run
the kernels too; the parameter dependence lives in the transfer
function between the plans.

Checks du/dnu and du/dt against central finite differences.

Run:  python examples_torch/jvp_sensitivity.py            (the card, 32^3)
      python examples_torch/jvp_sensitivity.py --device cpu
      python examples_torch/jvp_sensitivity.py --n 256     (256^3)
"""

from __future__ import annotations

import numpy as np
import torch

from _common import device, norm2, parser, real_pair, tensor

THETA = (0.05, 1.5)     # (nu, t)
EPS = 1e-3              # the finite-difference step


def wavenumbers(n: int) -> np.ndarray:
    """|k|^2 on the (n, n, n/2 + 1) half-spectrum, k in radians."""
    k = [np.fft.fftfreq(n) * 2 * np.pi, np.fft.fftfreq(n) * 2 * np.pi,
         np.fft.rfftfreq(n) * 2 * np.pi]
    return (k[0][:, None, None] ** 2 + k[1][None, :, None] ** 2
            + k[2][None, None, :] ** 2).astype(np.float32)


def solver(n: int, dev, seed: int = 0):
    """(solve, u0): solve(theta) is the diffused field of u0 at
    theta = (nu, t)."""
    fwd, inv = real_pair(n, dev)
    k2 = tensor(wavenumbers(n), dev)
    u0 = tensor(np.random.default_rng(seed).standard_normal(
        (n, n, n)).astype(np.float32), dev)

    def solve(theta):
        g = torch.exp(-theta[0] * k2 * theta[1])  # the heat kernel
        yr, yi = fwd(u0)
        return inv(yr * g, yi * g)
    return solve, u0


def rel(a, b) -> float:
    return (norm2(a - b) / norm2(b)) ** 0.5


def sensitivity(n: int, dev) -> dict:
    """The solver at n^3, then :func:`derivatives`."""
    return derivatives(solver(n, dev)[0], dev)


def derivatives(solve, dev) -> dict:
    """The Jacobian by jacfwd, its columns against central differences,
    and one jvp against the first column."""
    theta = torch.tensor(THETA, device=dev)
    jac = torch.func.jacfwd(solve)(theta)          # (n, n, n, 2)
    du_dnu, du_dt = jac[..., 0], jac[..., 1]
    e0 = torch.tensor([EPS, 0.0], device=dev)
    e1 = torch.tensor([0.0, EPS], device=dev)
    fd_nu = (solve(theta + e0) - solve(theta - e0)) / (2 * EPS)
    fd_t = (solve(theta + e1) - solve(theta - e1)) / (2 * EPS)
    # one jvp: one pass, one direction
    _, du = torch.func.jvp(solve, (theta,),
                           (torch.tensor([1.0, 0.0], device=dev),))
    return {"jac": jac, "nu": rel(du_dnu, fd_nu), "t": rel(du_dt, fd_t),
            "jvp": rel(du, du_dnu)}


def main(argv=None) -> int:
    ns = parser(__doc__, n=32).parse_args(argv)
    r = sensitivity(ns.n, device(ns.device))
    print(f"d u/d nu: jacfwd vs FD rel err {r['nu']:.2e}")
    print(f"d u/d t : jacfwd vs FD rel err {r['t']:.2e}")
    assert r["nu"] < 5e-3 and r["t"] < 5e-3, r
    assert r["jvp"] < 1e-5, r["jvp"]
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
