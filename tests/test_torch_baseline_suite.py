"""The port's BASELINE suite, ``offt_tpu_torch.bench.baseline_suite``, at
``--fast --device cpu`` (the reference's small sizes) against the
reference suite's records on the same sizes."""

import io
import json

import pytest

from offt_tpu_torch.bench import baseline_suite


@pytest.fixture(scope="module")
def records():
    out = io.StringIO()
    assert baseline_suite.main(["--fast", "--device", "cpu"], out=out) == 0
    return [json.loads(ln) for ln in out.getvalue().splitlines()]


@pytest.fixture(scope="module")
def reference(records):
    import contextlib

    from offt_tpu.bench.baseline_suite import main as r_main
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert r_main(["--fast"]) == 0
    return {r["config"]: r for r in map(json.loads,
                                        out.getvalue().splitlines())}


def test_five_records_and_config3_skipped(records):
    assert [r["config"] for r in records] == [1, 2, 3, 4, 5]
    assert records[2] == {"config": 3, "desc": "pencil (needs >1 device)",
                          "skipped": True}
    for rec in records[:2] + records[3:]:
        assert rec["pass"] is True, rec
        assert rec["rel_err"] < 1e-6 and rec["t_ms"] > 0
        assert rec["gflops"] > 0 and rec["bound_by"] == "bytes"
        assert rec["device"] == "cpu"
    c4 = records[3]
    assert c4["c2r_rel_err"] < 1e-6 and c4["c2r_t_ms"] > 0


@pytest.mark.parametrize("config", [1, 2, 4, 5])
def test_records_against_the_reference(records, reference, config):
    """Each configuration runs the reference suite's size (its desc names
    it) and both pass the 1e-6 bar, their errors of one order. The
    reference runs config 3 on its 8 virtual devices; the port without a
    torch.distributed world writes the skipped line."""
    mine = next(r for r in records if r["config"] == config)
    ref = reference[config]
    size = ref["desc"].split()[2] if config != 5 else ref["desc"].split()[1]
    assert size in mine["desc"]
    assert mine["pass"] and ref["pass"]
    assert 0.1 < mine["rel_err"] / ref["rel_err"] < 10
    assert reference[3]["pass"]


def test_a_failing_config_writes_its_error(monkeypatch):
    """A configuration that raises writes a record with the error and
    pass false; the suite goes on and exits 1."""
    def boom(*a):
        raise RuntimeError("CUDA out of memory")
    monkeypatch.setattr(baseline_suite, "config4", boom)
    out = io.StringIO()
    assert baseline_suite.main(["--fast", "--device", "cpu"], out=out) == 1
    recs = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert [r["config"] for r in recs] == [1, 2, 3, 4, 5]
    assert recs[3]["pass"] is False and "out of memory" in recs[3]["error"]
