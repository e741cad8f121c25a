"""offt_tpu_torch's complex128 and float64 mesh plans (the fp64 route on
the pencil engine) held against offt_tpu's and numpy's.

As tests/test_torch_pencil.py, on one spawned gloo world of 4 CPU ranks:
complex128 c2c forward and inverse and float64 r2c / c2r over the (1, 1),
(2, 2), (1, 4) and (4, 1) meshes (a (1, 1) mesh is rank 0's alone), on
shapes drawn as ``tests/test_fuzz.py`` draws them (each axis 4-20 for
c2c, 4-18 for real plans, from the same seeds: uneven blocks, padded
pencils and odd Nz among them). Each gathered output is held against
offt_tpu on a mesh of the same shape (jax x64, the same resolved
parameters) and against numpy complex128, both at 1e-12 relative norm,
the repo's fp64 bar; the reference against numpy too."""

import numpy as np
import pytest

import torch_world as tw

MESHES = [(1, 1), (2, 2), (1, 4), (4, 1)]


def _fuzz_shape(seed: int, hi: int) -> tuple:
    rng = np.random.default_rng(seed)
    return tuple(int(rng.integers(4, hi)) for _ in range(3))


CASES = []
for t, mesh in enumerate(MESHES):
    CASES += [tw.case(mesh=mesh, shape=_fuzz_shape(1000 + t, 21), fp64=True),
              tw.case(mesh=mesh, shape=_fuzz_shape(1004 + t, 21),
                      inverse=True, fp64=True),
              tw.case(mesh=mesh, shape=_fuzz_shape(2000 + t, 19), real=True,
                      fp64=True),
              tw.case(mesh=mesh, shape=_fuzz_shape(2004 + t, 19), real=True,
                      inverse=True, fp64=True)]
TOL = 1e-12


def _worker(rank, outdir):
    tw.run_cases(rank, outdir, CASES)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("pencil_fp64")
    tw.spawn(_worker, out)
    return out


def test_cases_cover_uneven_and_odd_shapes():
    shapes = [c["shape"] for c in CASES]
    # some axis not divisible by a mesh dim splitting it: padded pencils
    assert any(s[0] % c["mesh"][0] or s[1] % c["mesh"][1]
               for s, c in zip(shapes, CASES))
    assert any(c["real"] and c["shape"][2] % 2 for c in CASES)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[tw.case_id(c) for c in CASES])
def test_fp64_pencil_matches_reference(world, i):
    c = CASES[i]
    got, params, ran = tw.gather(world, i, c)
    assert got.dtype == (np.float64 if c["real"] and c["inverse"]
                         else np.complex128)
    ref = tw.reference(c, tw.inputs(c, i), params)
    want = tw.truth(c, i)
    assert got.shape == ref.shape == want.shape == tw.out_shape(c)
    assert tw.rel_err(got, want) < TOL
    assert tw.rel_err(ref, want) < TOL
    assert tw.rel_err(got, ref) < TOL
    # the fp64 route reads no f32 kernel
    assert not ran
