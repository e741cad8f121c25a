"""offt_tpu_torch's meshes, block layouts and distributed parameters held
against offt_tpu's, in one process (no process group).

- Rank grids: the port's ``_grid_ranks`` on ranks against the reference's
  ``_grid_devices`` on the ids of the 8 virtual CPU devices
  (tests/conftest.py), for the three rank orders.
- Blocks: a rank's ``Layout.block`` of a global shape against the index
  the reference's sharding gives the device at the same mesh coordinate
  on the padded global shape, clipped to the true one (its padded static
  shards, ``plan/api.py:254-269``).
- ``default_params`` and ``infeasible_reason`` of both packages on a grid
  of shapes, device counts and knobs. ``use_pallas`` differs by design:
  the reference enables its kernels on a TPU only, the port everywhere.
"""

import dataclasses

import jax
import numpy as np
import pytest

from offt_tpu.dist import mesh as rmesh
from offt_tpu.plan import params as rparams
from offt_tpu_torch.dist import mesh as tmesh
from offt_tpu_torch.plan import params as tparams

GRIDS = [(1, 8), (2, 4), (4, 2), (8, 1), (2, 2), (1, 1), (3, 2)]


@pytest.mark.parametrize("p1,p2", GRIDS)
@pytest.mark.parametrize("rankorder", [tmesh.RANKORDER_AUTO,
                                       tmesh.RANKORDER_ROW,
                                       tmesh.RANKORDER_COL])
def test_rank_grid_matches_reference(p1, p2, rankorder):
    ref = rmesh._grid_devices(jax.devices(), p1, p2, rankorder)
    port = tmesh._grid_ranks(range(8), p1, p2, rankorder)
    assert port.shape == (p1, p2)
    assert port.tolist() == [[d.id for d in row] for row in ref]


def test_rank_grid_refuses_an_unknown_order():
    with pytest.raises(ValueError):
        tmesh._grid_ranks(range(4), 2, 2, 3)


def _ref_blocks(sharding, shape, padded):
    """{mesh coordinate: the true slices} of the reference's sharding of
    the padded global shape."""
    mesh = sharding.mesh
    where = {d.id: idx for idx, d in np.ndenumerate(mesh.devices)}
    out = {}
    for dev, idx in sharding.devices_indices_map(padded).items():
        coord = dict(zip(mesh.axis_names, where[dev.id]))
        key = tuple(sorted(coord.items()))
        out[key] = tuple(slice(min(s.start or 0, n), min(s.stop or p, n))
                         for s, n, p in zip(idx, shape, padded))
    return out


def _padded(layout, shape):
    size = dict(layout.sizes)
    out = []
    for n, e in zip(shape, layout.dims):
        names = () if e is None else (e,) if isinstance(e, str) else e
        p = int(np.prod([size[k] for k in names]))
        out.append(-(-n // p) * p)
    return tuple(out)


MESHES = [("plain", (2, 2)), ("plain", (1, 4)), ("plain", (4, 1)),
          ("plain", (2, 4)), ("slice", (2, 2, 2))]
SHAPES = [(8, 8, 16), (10, 12, 15), (5, 3, 7), (1, 2, 9)]


def _ref_mesh(kind, dims):
    if kind == "slice":
        return rmesh.make_multislice_mesh(*dims)
    return rmesh.make_mesh(*dims)


@pytest.mark.parametrize("kind,dims", MESHES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("which", ["input", "output"])
def test_blocks_match_reference_shards(kind, dims, shape, which):
    rm = _ref_mesh(kind, dims)
    ndim = 4 if kind == "slice" else 3
    gshape = ((6,) if ndim == 4 else ()) + shape
    sizes = dict(zip(rm.axis_names, rm.devices.shape))
    layout = getattr(tmesh, f"{which}_layout")(sizes, ndim)
    ref_sh = getattr(rmesh, f"{which}_sharding")(rm, ndim)
    assert layout.dims == tuple(ref_sh.spec)
    padded = _padded(layout, gshape)
    ref = _ref_blocks(ref_sh, gshape, padded)
    assert len(ref) == int(np.prod(rm.devices.shape))
    covered = np.zeros(gshape, np.int32)
    for key, want in ref.items():
        got = layout.block(gshape, dict(key))
        assert got == want, (key, got, want)
        assert layout.local_shape(gshape, dict(key)) == tuple(
            s.stop - s.start for s in want)
        covered[got] += 1
    # replicated dims aside, the blocks tile the global array once
    rep = int(np.prod([n for k, n in sizes.items()
                       if k not in _split_names(layout)]))
    assert (covered == rep).all()


def _split_names(layout):
    out = set()
    for e in layout.dims:
        if e is not None:
            out.update((e,) if isinstance(e, str) else e)
    return out


@pytest.mark.parametrize("shape", [(16, 8, 8), (9, 8, 8), (3, 4, 4)])
def test_batch_layout_matches_reference(shape):
    rm = rmesh.make_mesh(2, 4)
    from jax.sharding import NamedSharding, PartitionSpec as P
    ref_sh = NamedSharding(rm, P((rmesh.ROW, rmesh.COL), None, None, None))
    layout = tmesh.batch_layout({"row": 2, "col": 4}, 4)
    gshape = shape + (6,)
    ref = _ref_blocks(ref_sh, gshape, _padded(layout, gshape))
    for key, want in ref.items():
        assert layout.block(gshape, dict(key)) == want


def test_multislice_needs_a_batch_dim():
    with pytest.raises(ValueError, match="batch"):
        tmesh.input_layout({"slice": 2, "row": 2, "col": 2}, 3)
    with pytest.raises(ValueError, match="batch"):
        rmesh.input_sharding(rmesh.make_multislice_mesh(2, 2, 2), 3)


def _spec_pair(shape, p, real, inverse):
    kw = dict(shape=shape, real=real, inverse=inverse, p=p)
    return rparams.ProblemSpec(**kw), tparams.ProblemSpec(**kw)


def _fields(params, drop=("use_pallas",)):
    d = dataclasses.asdict(params)
    for k in drop:
        d.pop(k)
    return d


PARAM_SHAPES = [(64, 64, 64), (16, 32, 128), (8, 8, 16), (3, 5, 7),
                (256, 256, 512)]


@pytest.mark.parametrize("shape", PARAM_SHAPES)
@pytest.mark.parametrize("p", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("real,inverse", [(False, False), (False, True),
                                          (True, False), (True, True)])
def test_default_params_match_reference(shape, p, real, inverse):
    rs, ts = _spec_pair(shape, p, real, inverse)
    assert tparams.p1_candidates(*shape, p) == rparams.p1_candidates(
        *shape, p)
    for p1 in (None, 1, 2):
        if p1 is not None and p % p1:
            continue
        rp = rparams.default_params(rs, p1=p1)
        tp = tparams.default_params(ts, p1=p1)
        assert _fields(tp) == _fields(rp), (p1, tp, rp)
        assert (tparams.infeasible_reason(ts, tp) is None) == \
            (rparams.infeasible_reason(rs, rp.replace(
                use_pallas=tp.use_pallas)) is None)


KNOBS = [dict(), dict(t1=2, t2=2), dict(t1=4, t2=1, w1=2), dict(t1=9),
         dict(t2=9), dict(w1=3, t1=2), dict(w2=-1), dict(ry=0), dict(ry=11),
         dict(ry=5), dict(s1=1, s2=1), dict(s1=2), dict(v=3), dict(v=4),
         dict(rankorder=2), dict(rankorder=3), dict(p1=3), dict(p1=2),
         dict(t1=8, t2=8, w1=0, w2=0), dict(precision="stack6"),
         dict(slab_rows=3), dict(radix_z=(4, 4)), dict(radix_y=(2, 2, 2))]


@pytest.mark.parametrize("knobs", KNOBS)
@pytest.mark.parametrize("shape,p", [((16, 16, 16), 4), ((8, 8, 16), 8),
                                     ((10, 12, 15), 4), ((8, 16, 32), 2)])
@pytest.mark.parametrize("real,inverse", [(False, False), (True, True)])
def test_infeasible_reason_matches_reference(knobs, shape, p, real,
                                             inverse):
    rs, ts = _spec_pair(shape, p, real, inverse)
    base = dict(p1=2 if p % 2 == 0 else 1, use_pallas=1,
                precision="highest")
    base.update(knobs)
    rr = rparams.infeasible_reason(rs, rparams.PlanParams(**base))
    tr = tparams.infeasible_reason(ts, tparams.PlanParams(**base))
    assert tr == rr


def test_buffer_limit_matches_reference():
    # 1024^3 on 2 devices: one unchunked phase holds 2^29 elements
    rs, ts = _spec_pair((1024, 1024, 1024), 2, False, False)
    for kw in (dict(p1=2), dict(p1=2, t1=64, t2=64, w1=1, w2=1)):
        rr = rparams.infeasible_reason(rs, rparams.PlanParams(**kw))
        tr = tparams.infeasible_reason(ts, tparams.PlanParams(**kw))
        assert tr == rr
    assert tparams.infeasible_reason(
        ts, tparams.PlanParams(p1=2)) == \
        "pipeline working set exceeds BUFFER_ELEMS_LIMIT"
    assert tparams.BUFFER_ELEMS_LIMIT == rparams.BUFFER_ELEMS_LIMIT
