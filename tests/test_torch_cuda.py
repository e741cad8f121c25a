"""Each CUDA kernel of offt_tpu_torch against its plain version, on the
card. Marked ``cuda``: they skip without a GPU. The file imports no JAX,
so it also runs on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

import offt_tpu_torch as ot
from offt_tpu_torch.kernels import fused_fft as ff


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pair(shape, dev, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape)
                                  .astype(np.float32)).to(dev)
                 for _ in range(2))


def _card_check(fn, call, shape, dev, lanes=None):
    """One launch of ``fn`` against its plain version on the same inputs:
    max |kernel - plain| / max |plain| <= 1e-6 (f32 on both sides; the
    sums run in other orders)."""
    x = _pair(shape, dev)
    ff.reset_counts()
    got = call(fn, x)
    want = call(fn.plain, x)
    torch.cuda.synchronize()
    assert sum(c[0] for c in ff.counts().values()) == 1
    for g, w in zip(got, want):
        if lanes:
            g, w = g[..., :lanes], w[..., :lanes]
        assert torch.isfinite(g).all()
        assert ((g - w).abs().max() / w.abs().max()).item() < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 320, 1024, 16384])
def test_cuda_fft_last(cuda_dev, n):
    _card_check(ff.fft_last, lambda f, x: f(*x, scale=0.5), (33, n),
                cuda_dev)


@pytest.mark.cuda
def test_cuda_fft_last_three_stages_in_place(cuda_dev):
    _card_check(ff.fft_last, lambda f, x: f(x[0].clone(), x[1].clone(),
                                            radices=(4, 4, 4), alias=True),
                (7, 64), cuda_dev)


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [0, 1])
def test_cuda_fft_sublane(cuda_dev, axis):
    _card_check(ff.fft_sublane, lambda f, x: f(*x, axis), (16, 32, 128),
                cuda_dev)


@pytest.mark.cuda
def test_cuda_fft_slab_yz(cuda_dev):
    _card_check(ff.fft_slab_yz, lambda f, x: f(*x, zpad=8, scale=0.5),
                (4, 32, 128), cuda_dev, lanes=128)


@pytest.mark.cuda
def test_cuda_fft_slab_yz_in_place(cuda_dev):
    _card_check(ff.fft_slab_yz, lambda f, x: f(x[0].clone(), x[1].clone(),
                                               inverse=True, alias=True),
                (3, 20, 48), cuda_dev)


@pytest.mark.cuda
def test_cuda_fft_x_from_padded(cuda_dev):
    _card_check(ff.fft_x_from_padded, lambda f, x: f(*x, 128),
                (16, 32, 136), cuda_dev)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 128, 128), (16, 32, 128),
                                   (32, 32, 32), (2, 1, 32, 64)])
@pytest.mark.parametrize("inverse", [False, True])
def test_cuda_plan_against_fftn(cuda_dev, shape, inverse):
    x = _pair(shape, cuda_dev, seed=1)
    bd = len(shape) - 3
    p = ot.plan(shape[bd:], "complex64", planar=True, inverse=inverse,
                batch_dims=bd, norm="ortho", device=cuda_dev)
    ff.reset_counts()
    yr, yi = p(x)
    assert sum(c[1] for c in ff.counts().values()) == 0
    assert sum(c[0] for c in ff.counts().values()) >= 2
    c = torch.complex(x[0].double(), x[1].double())
    f = torch.fft.ifftn if inverse else torch.fft.fftn
    ref = f(c, dim=(-3, -2, -1), norm="ortho")
    y = torch.complex(yr.double(), yi.double())
    assert (torch.linalg.vector_norm(y - ref)
            / torch.linalg.vector_norm(ref)).item() < 1e-6
