"""offt_tpu_torch.tune.build_space against offt_tpu.tune.build_space: the
dimension lists compared spec by spec, every difference stated with its
reason, and the pieces the port decides for itself (which kernel knobs
a route reads, the four-step splits it offers and their order, the
space's base point)."""

import pytest

# why a reference dimension is not in the port's space
REGISTER = "its axis runs the register core, which ignores it"
FOURSTEP = "the four-step route reads split_1d, not the radices"
ONE_VALUE = "one candidate: a one-valued dimension searches nothing"
NO_BLOCK = "no kernel of the route reads block_batch"
UNREAD = "no kernel of the port reads it (slab_rows, x_tile)"
F32 = "every precision computes at f32 on the card (ROADMAP Queue 3)"
PLAIN = ("use_pallas=0 is the unfused engine, plain PyTorch: a winner "
         "there would take the plan off its kernels")

# (shape, real, p, the reference's dimensions missing from the port's
# with the reason of each); both spaces with the kernel dimensions
CASES = [
    ((16, 16, 16), False, 8,
     {"radix_z": REGISTER, "radix_y": REGISTER, "radix_x": REGISTER,
      "block_batch": NO_BLOCK, "slab_rows": UNREAD, "precision": F32, "use_pallas": PLAIN}),
    ((1, 1, 3 * 2 ** 18), False, 1,
     {"radix_z": FOURSTEP, "radix_y": ONE_VALUE, "radix_x": ONE_VALUE,
      "slab_rows": UNREAD, "precision": F32, "use_pallas": PLAIN}),
    ((1, 1, 2 ** 20), False, 1,
     {"radix_z": FOURSTEP, "radix_y": ONE_VALUE, "radix_x": ONE_VALUE,
      "block_batch": NO_BLOCK, "slab_rows": UNREAD, "precision": F32, "use_pallas": PLAIN}),
    ((192, 192, 192), True, 1,
     {"radix_y": REGISTER, "radix_x": REGISTER, "block_batch": NO_BLOCK,
      "slab_rows": UNREAD, "precision": F32, "use_pallas": PLAIN}),
    ((256, 256, 256), False, 1,
     {"radix_z": REGISTER, "radix_y": REGISTER, "radix_x": REGISTER,
      "block_batch": NO_BLOCK, "slab_rows": UNREAD, "x_tile": UNREAD,
      "precision": F32, "use_pallas": PLAIN}),
    ((256, 256, 256), True, 1,
     {"radix_z": REGISTER, "radix_y": REGISTER, "radix_x": REGISTER,
      "block_batch": NO_BLOCK, "slab_rows": UNREAD, "x_tile": UNREAD,
      "precision": F32, "use_pallas": PLAIN}),
    ((8, 8, 8), False, 1,
     {"slab_rows": UNREAD, "precision": F32, "use_pallas": PLAIN}),
    ((32, 64, 4096), False, 4,
     {"radix_z": REGISTER, "radix_y": REGISTER, "radix_x": REGISTER,
      "block_batch": NO_BLOCK, "slab_rows": UNREAD, "x_tile": UNREAD,
      "precision": F32, "use_pallas": PLAIN}),
    ((1, 1, 65536), False, 8,
     {"radix_z": FOURSTEP, "radix_y": ONE_VALUE, "radix_x": ONE_VALUE,
      "block_batch": NO_BLOCK, "slab_rows": UNREAD, "precision": F32, "use_pallas": PLAIN}),
]


def _spaces(shape, real, p, **kw):
    from offt_tpu.plan.params import ProblemSpec as RSpec
    from offt_tpu.tune.space import build_space as r_build

    from offt_tpu_torch.plan.params import ProblemSpec
    from offt_tpu_torch.tune import build_space

    ref = r_build(RSpec(shape=shape, real=real, p=p), **kw)
    ours = build_space(ProblemSpec(shape=shape, real=real, p=p),
                       include_radix=kw.get("include_radix", True),
                       include_pallas=kw.get("include_pallas"),
                       device="cuda" if kw.get("include_pallas") else "cpu")
    return ref, ours


@pytest.mark.parametrize("shape,real,p,dropped", CASES,
                         ids=[f"{'x'.join(map(str, c[0]))}"
                              f"{'-r2c' if c[1] else ''}-p{c[2]}"
                              for c in CASES])
def test_space_against_the_reference(shape, real, p, dropped):
    ref, ours = _spaces(shape, real, p, include_pallas=True)
    rnames = list(ref.names)
    assert [n for n in rnames if n not in dropped] == list(ours.names)
    assert set(dropped) <= set(rnames)
    for d in ours.dims:
        r = ref.dims[rnames.index(d.name)]
        if d.name == "split_1d":
            # the same candidates but the order (and so the cut to 8)
            assert d.values[0] is None and r.values[0] is None
            assert len(d.values) == len(r.values)
            continue
        assert d.values == r.values, d.name
    # the distributed dimensions come first, value for value
    dist = ("p1", "t1", "t2", "w1", "w2", "ry", "s1", "s2", "v",
            "rankorder")
    assert [n for n in ours.names if n in dist] == \
        [n for n in rnames if n in dist]


def test_kernel_dimensions_follow_the_device():
    """On a cuda device the kernel dimension (block_batch, where a dense
    kernel reads it) comes by default; on the CPU only when asked. No
    probing decides it, and use_pallas is never searched."""
    from offt_tpu_torch.plan.params import ProblemSpec
    from offt_tpu_torch.tune import build_space

    spec = ProblemSpec(shape=(8, 8, 8))
    assert "block_batch" in build_space(spec).names      # plan()'s default
    assert "block_batch" in build_space(spec, device="cuda").names
    assert "block_batch" not in build_space(spec, device="cpu").names
    assert "block_batch" in build_space(spec, device="cpu",
                                        include_pallas=True).names
    assert "block_batch" not in build_space(spec, device="cuda",
                                            include_pallas=False).names
    for shape, real in (((8, 8, 8), False), ((192, 192, 192), True),
                        ((1, 1, 3 * 2 ** 18), False), ((256,) * 3, False)):
        sp = build_space(ProblemSpec(shape=shape, real=real), device="cuda")
        assert "use_pallas" not in sp.names
        assert sp.base.use_pallas == 1
    # complex128: the unfused engine alone, no kernel dimensions
    wide = ProblemSpec(shape=(64, 64, 64), dtype="complex128")
    ref, _ = _spaces((64, 64, 64), False, 1, include_pallas=False)
    assert build_space(wide, device="cuda").names == ref.names


@pytest.mark.parametrize("n,searched", [
    (3 * 2 ** 18, True), (3 * 2 ** 16, False), (5 * 2 ** 14, False)])
def test_block_batch_beside_split_1d(n, searched):
    """Beside split_1d, block_batch is searched only where a kernel of
    the pair runs dense at every split searched: at 3 * 2^18 every split
    has a side of 3 * 2^k, which the dense core takes; at 3 * 2^16 and
    5 * 2^14 some split puts both kernels on the register core, whose
    points would time the same kernels at every block_batch."""
    from offt_tpu_torch.plan.params import ProblemSpec
    from offt_tpu_torch.tune import build_space
    from offt_tpu_torch.tune.space import (_pair_dense, _split1d_candidates,
                                           kernel_knobs)

    spec = ProblemSpec(shape=(1, 1, n))
    splits = _split1d_candidates(spec)[1:]
    assert "block_batch" in kernel_knobs(spec)       # at the default split
    assert all(_pair_dense(*sp) for sp in splits) == searched
    names = build_space(spec, device="cuda").names
    assert names == (("split_1d", "block_batch") if searched
                     else ("split_1d",))


@pytest.mark.parametrize("shape,real,inverse,want", [
    ((192, 192, 192), True, False, {"radix_z"}),
    ((192, 192, 192), True, True, set()),
    ((8, 8, 8), False, False, {"radix_z", "radix_y", "radix_x",
                               "block_batch"}),
    ((256, 256, 256), False, False, set()),
    ((320, 320, 320), False, False, set()),
    ((24, 48, 40), False, False, {"radix_z", "radix_y", "radix_x",
                                  "block_batch"}),
    ((1, 1, 3 * 2 ** 18), False, False, {"block_batch"}),
    ((1, 1, 2 ** 20), False, False, set()),
    ((1, 1, 1000003), False, False, {"radix_z"}),
    ((1, 1, 2 ** 15), False, False, set()),
    ((8, 64, 2 ** 15), False, False, {"radix_x"}),
])
def test_kernel_knobs(shape, real, inverse, want):
    """What the route of a float32 plan reads: 192^3's real route runs
    rfft_last at M = 96 on the dense core (its c2r, irfft_1d around a
    c2c of 96 on the mixed register rows, reads none); lengths under 16
    and the rows of 40 (a factor 5 below the mixed lengths) run dense,
    so the (48, 40) slab does; 3 * 2^18's pair runs step 3 dense at 768,
    2^15's pair (128, 256) and 2^20's on the register core; a prime takes
    Bluestein on the unfused engine; an x of 8 runs dense, but on the
    pitched pass (the stride gate at (64, 2^15)), which takes no
    block_batch."""
    from offt_tpu_torch.plan.params import ProblemSpec
    from offt_tpu_torch.tune.space import kernel_knobs

    assert kernel_knobs(ProblemSpec(shape=shape, real=real,
                                    inverse=inverse)) == want


def test_split_candidates_order():
    """The port ranks the four-step splits by what the card runs: the
    fused pair (both factors 128-multiples) first, then fewer kernels off
    the register core, then the balanced; the reference by Mosaic's lane
    rule. Both offer the same kind of candidates."""
    from offt_tpu.plan.params import ProblemSpec as RSpec
    from offt_tpu.tune.space import _split1d_candidates as r_cands

    from offt_tpu_torch.plan.params import ProblemSpec
    from offt_tpu_torch.tune.space import _split1d_candidates, _split_order

    for n in (2 ** 20, 3 * 2 ** 18, 2 ** 22):
        ours = _split1d_candidates(ProblemSpec(shape=(1, 1, n)))
        ref = r_cands(RSpec(shape=(1, 1, n)))
        assert ours[0] is None and len(ours) == len(ref) == 8
        assert all(a * b == n for a, b in ours[1:])
        assert list(ours[1:]) == sorted(ours[1:], key=_split_order)
    two20 = _split1d_candidates(ProblemSpec(shape=(1, 1, 2 ** 20)))
    assert two20[1] == (1024, 1024)
    mixed = _split1d_candidates(ProblemSpec(shape=(1, 1, 3 * 2 ** 18)))
    assert set(mixed[1:3]) == {(1024, 768), (768, 1024)}


def test_split_candidates_are_p_divisible():
    """The port's form of tests/test_dist1d.py::
    test_dist1d_space_candidates_are_p_divisible: a distributed spec
    offers only P-divisible pairs (the long-1-D engine's); one device
    offers none where one kernel launch takes the line; the same length
    distributed does."""
    from offt_tpu_torch.plan.params import ProblemSpec
    from offt_tpu_torch.tune.space import _split1d_candidates

    cands = _split1d_candidates(ProblemSpec(shape=(1, 1, 65536), p=8))
    assert len(cands) > 1
    for c in cands[1:]:
        assert c[0] % 8 == 0 and c[1] % 8 == 0, c
    assert _split1d_candidates(ProblemSpec(shape=(1, 1, 4096))) == (None,)
    assert len(_split1d_candidates(ProblemSpec(shape=(1, 1, 4096),
                                               p=8))) > 1
    # one launch of fft_last takes 16384 = 128 * 128; 32768 takes the pair
    assert _split1d_candidates(ProblemSpec(shape=(1, 1, 16384))) == (None,)
    assert len(_split1d_candidates(ProblemSpec(shape=(1, 1, 32768)))) > 1
    assert _split1d_candidates(ProblemSpec(shape=(1, 1, 65536),
                                           real=True)) == (None,)


def test_space_base_is_the_default_point():
    """Fields outside the dimensions come from the default point, so the
    default point maps to itself and a tuned plan keeps the port's
    kernels, use_pallas being never searched (the reference's to_params
    gives PlanParams()'s use_pallas=0)."""
    from offt_tpu_torch.plan.params import ProblemSpec, default_params
    from offt_tpu_torch.tune import build_space

    spec = ProblemSpec(shape=(32, 64, 4096), p=4)
    sp = build_space(spec, fixed_p1=2, device="cpu")
    dflt = default_params(spec, p1=2)
    assert sp.base == dflt and dflt.use_pallas == 1
    assert sp.to_params(sp.from_params(dflt)) == dflt
    assert sp.to_params((0,) * len(sp.dims)).use_pallas == 1
