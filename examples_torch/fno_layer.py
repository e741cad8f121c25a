"""A Fourier Neural Operator layer on differentiable plans.

The port of examples/fno_layer.py. A spectral-convolution layer (the
FNO building block: rfft3, learned complex weights on the low modes,
irfft3) as a ``torch.nn.Module`` whose parameters are trained with SGD
through the port's r2c and c2r plans (offt_tpu_torch/plan/autodiff.py:
each backward runs the adjoint plan). It learns a hidden linear operator,
a known spectral multiplier, from input / output pairs, and must recover
it.

With the reference's 200 steps the fit must converge (the loss below
1e-4 of its start, the weights within 5%); with fewer steps (``--steps``,
the card's run at 4 x 128^3) the loss must fall at every step.

Run:  python examples_torch/fno_layer.py                 (the card, 32^3)
      python examples_torch/fno_layer.py --device cpu
      python examples_torch/fno_layer.py --n 128 --modes 16 --steps 5
"""

from __future__ import annotations

import numpy as np
import torch

from _common import device, norm2, parser, real_pair, tensor

STEPS = 200
BATCH = 4


class SpectralConv3d(torch.nn.Module):
    """rfft3, the (modes, modes, modes) low corner (bins 0..modes - 1 of
    each axis) times learned complex weights (``wr`` + i ``wi``), irfft3.
    Complex-linear in x; x is (batch, n, n, n)."""

    def __init__(self, n: int, modes: int, dev):
        super().__init__()
        self.wr = torch.nn.Parameter(torch.zeros((modes,) * 3, device=dev))
        self.wi = torch.nn.Parameter(torch.zeros((modes,) * 3, device=dev))
        self.fwd, self.inv = real_pair(n, dev, batch_dims=1)
        nf = n // 2 + 1
        self.pad = (0, nf - modes, 0, n - modes, 0, n - modes)

    def forward(self, x):
        yr, yi = self.fwd(x)
        fr = torch.nn.functional.pad(self.wr, self.pad)
        fi = torch.nn.functional.pad(self.wi, self.pad)
        return self.inv(yr * fr - yi * fi, yr * fi + yi * fr)


def data(n: int, modes: int, dev, seed: int = 0, batch: int = BATCH):
    """(w_true (re, im), x_train) from ``seed``, as numpy float32."""
    rng = np.random.default_rng(seed)
    wr = rng.standard_normal((modes,) * 3).astype(np.float32)
    wi = rng.standard_normal((modes,) * 3).astype(np.float32)
    x = rng.standard_normal((batch, n, n, n)).astype(np.float32)
    return (wr, wi), x


def setup(n: int, modes: int, dev):
    """(layer at zero weights, x_train, y_train, w_true)."""
    (wr, wi), x = data(n, modes, dev)
    layer = SpectralConv3d(n, modes, dev)
    x = tensor(x, dev)
    with torch.no_grad():
        layer.wr.copy_(tensor(wr, dev))
        layer.wi.copy_(tensor(wi, dev))
        y = layer(x)
        layer.wr.zero_()
        layer.wi.zero_()
    return layer, x, y, (wr, wi)


def loss_of(layer, x, y):
    r = layer(x) - y
    return (r * r).mean()


def train(n: int, modes: int, dev, steps: int = STEPS) -> dict:
    """The layer and its data at n^3, then :func:`fit`."""
    layer, x, y, (wr, wi) = setup(n, modes, dev)
    return fit(layer, x, y, wr, steps)


def fit(layer, x, y, wr, steps: int = STEPS) -> dict:
    """``steps`` of SGD from zero weights: the losses (one more after the
    last step) and the weights' error against the hidden ones (``wr``,
    their real parts)."""
    dev, n = x.device, x.shape[-1]
    with torch.no_grad():
        layer.wr.zero_()
        layer.wi.zero_()
    # spectral-domain parameters see an N^3-scaled gradient
    opt = torch.optim.SGD(layer.parameters(), lr=2e-2 * n ** 3)
    losses = []
    for step in range(steps + 1):
        loss = loss_of(layer, x, y)
        losses.append(loss.item())
        if step == steps:
            break
        opt.zero_grad()
        loss.backward()
        opt.step()
    with torch.no_grad():
        werr = (norm2(layer.wr - tensor(wr, dev)) / float(
            np.sum(wr.astype(np.float64) ** 2))) ** 0.5
    return {"losses": losses, "werr": werr}


def main(argv=None) -> int:
    ns = parser(__doc__, n=32, modes=8, steps=STEPS).parse_args(argv)
    r = train(ns.n, ns.modes, device(ns.device), ns.steps)
    ls = r["losses"]
    print(f"loss {ls[0]:.4f} -> {ls[-1]:.3e} in {ns.steps} steps; "
          f"recovered weight rel err {r['werr']:.4f}")
    if ns.steps >= STEPS:
        assert ls[-1] < 1e-4 * ls[0] and r["werr"] < 0.05, r
    else:
        assert all(b < a for a, b in zip(ls, ls[1:])), ls
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
