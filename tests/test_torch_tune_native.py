"""offt_tpu_torch.tune.engine_cpp: the native C++ engine and server of
the repository's native/ built with g++ into the port's own directory,
held against the reference's binding (the same point sequence under the
same seed) and through the reference's tests/test_engine_cpp.py and
tests/test_native_server.py cases; and the port's builds racing each
other."""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from offt_tpu_torch.tune import engine_cpp

if not engine_cpp.available():
    pytest.skip("no native toolchain", allow_module_level=True)

from offt_tpu_torch.tune import Tuner  # noqa: E402
from offt_tpu_torch.tune.client import ServiceClient  # noqa: E402
from offt_tpu_torch.tune.synth import ah_quadratic, quadratic_space  # noqa


def _trials(tuner):
    return [(tuple(int(i) for i in t.point), t.perf, t.status)
            for t in tuner.trials]


@pytest.mark.parametrize("name", ["random", "nm", "pro", "brute"])
def test_native_engine_matches_the_references(name, monkeypatch):
    """The reference's binding and strategy wrapper against the port's,
    both on the engine of native/offt_tune_engine.cpp. The reference's
    binding loads the port's build of it: its own builds write
    native/build/ in place, which its tests in other workers may be
    writing at the same moment."""
    r_engine = pytest.importorskip("offt_tpu.tune.engine_cpp")
    from offt_tpu.tune.synth import quadratic_space as r_space
    from offt_tpu.tune.tuner import Tuner as RTuner

    monkeypatch.setattr(r_engine, "_lib", None)
    monkeypatch.setattr(r_engine, "build_library",
                        lambda force=False: engine_cpp.build_library())

    budget = 150 if name == "brute" else 300
    ref = RTuner(r_space(), objective=ah_quadratic,
                 strategy=r_engine.make_native_strategy(name, r_space(),
                                                        seed=3),
                 max_trials=budget)
    r_best = ref.run()
    got = Tuner(quadratic_space(), objective=ah_quadratic,
                strategy=engine_cpp.make_native_strategy(
                    name, quadratic_space(), seed=3), max_trials=budget)
    assert got.run() == r_best
    assert _trials(got) == _trials(ref)


def test_builds_into_the_ports_directory():
    here = os.path.dirname(engine_cpp.__file__)
    assert engine_cpp.build_library().parent == engine_cpp._BUILD_DIR
    assert str(engine_cpp._BUILD_DIR) == os.path.join(here, "build")
    assert engine_cpp._SRC.parent.name == "native"


def test_concurrent_builds_leave_a_whole_library(tmp_path, monkeypatch):
    """Builds started at once (test workers) each write their own file
    and rename it into place: every one returns a library that loads and
    no temporary file is left behind."""
    import ctypes

    monkeypatch.setattr(engine_cpp, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(engine_cpp, "_LIB_PATH", tmp_path / "liboffttune.so")
    out, errs = [], []

    def build():
        try:
            out.append(engine_cpp.build_library(force=True))
        except Exception as e:  # surfaced below
            errs.append(e)

    ths = [threading.Thread(target=build) for _ in range(3)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(120)
    assert not errs and len(out) == 3
    ctypes.CDLL(str(out[0])).ote_create
    assert sorted(p.name for p in tmp_path.iterdir()) == ["liboffttune.so"]


def run_native(name, max_trials=400, seed=3):
    space = quadratic_space()
    strat = engine_cpp.make_native_strategy(name, space, seed=seed)
    tuner = Tuner(space, objective=ah_quadratic, strategy=strat,
                  max_trials=max_trials)
    return tuner.run() + (tuner,)


def test_native_random():
    assert run_native("random", max_trials=300)[1] < 6 * 50 ** 2


def test_native_nm():
    best, perf, _ = run_native("nm", max_trials=500)
    assert perf <= 40, f"native nm best {best} perf {perf}"


def test_native_pro():
    best, perf, t = run_native("pro", max_trials=500)
    assert perf <= 400, f"native pro best {best} perf {perf}"
    assert t.strategy.converged()


def test_native_brute_exhaustive():
    from offt_tpu_torch.plan.params import ProblemSpec
    from offt_tpu_torch.tune import Dimension
    from offt_tpu_torch.tune.synth import _SynthSpace

    space = _SynthSpace(spec=ProblemSpec(shape=(1, 1, 1)), dims=tuple(
        Dimension(f"v{i}", tuple(range(5, 16))) for i in range(2)))
    tuner = Tuner(space, objective=lambda v: (v[0] - 7) ** 2
                  + (v[1] - 12) ** 2,
                  strategy=engine_cpp.make_native_strategy("brute", space),
                  max_trials=10_000)
    assert tuner.run() == ((7, 12), 0)


def test_native_matches_python_protocol():
    strat = engine_cpp.make_native_strategy("nm", quadratic_space(), seed=1,
                                            init_simplex=[(0,) * 6])
    pt = strat.generate()
    assert pt is not None and len(pt) == 6
    strat.analyze(pt, 123.0)
    assert strat.best() == pt
    with pytest.raises(ValueError):
        engine_cpp.make_native_strategy("annealing", quadratic_space())


# ---- the native server (hserver parity) ----------------------------------

@pytest.fixture()
def native_server():
    proc, port = engine_cpp.spawn_server()
    yield port
    proc.kill()
    proc.wait()


def test_native_nm_session(native_server):
    with ServiceClient("127.0.0.1", native_server) as c:
        c.create_session([(f"v{i}", list(range(1, 101))) for i in range(6)],
                         strategy="nm", seed=2)
        best = float("inf")
        for _ in range(300):
            pt = c.generate()
            if pt is None:
                break
            perf = ah_quadratic([p + 1 for p in pt])
            best = min(best, perf)
            c.analyze(pt, perf)
            if c.converged():
                break
        assert best <= 400
        assert c.best() is not None


def test_native_http_monitor_and_live_api(native_server):
    base = f"http://127.0.0.1:{native_server}"
    with ServiceClient("127.0.0.1", native_server) as c:
        c.create_session([("x", list(range(10)))], strategy="random",
                         name="live-native")
        c.analyze(c.generate(), 2.5)
        api = json.loads(urllib.request.urlopen(
            base + "/api/sessions", timeout=5).read())
        assert api[0]["name"] == "live-native" and api[0]["trials"] == 1
        assert "live-native" in urllib.request.urlopen(
            base + "/", timeout=5).read().decode()
        j = json.loads(urllib.request.urlopen(
            base + "/api/session/1", timeout=5).read())
        assert j["total"] == 1 and j["trials"][0][2] == 2.5
        j2 = json.loads(urllib.request.urlopen(
            base + "/api/session/1?since=1", timeout=5).read())
        assert j2["trials"] == []
        c.analyze(c.generate(), 0.25)
        j3 = json.loads(urllib.request.urlopen(
            base + "/api/session/1?since=1", timeout=5).read())
        assert len(j3["trials"]) == 1 and j3["best"]["perf"] == 0.25
        page = urllib.request.urlopen(base + "/session/1",
                                      timeout=5).read().decode()
        assert "/api/session/" in page and "setTimeout(tick" in page
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(base + "/api/session/99", timeout=5)
    assert e.value.code == 404


def test_native_server_bad_input(native_server):
    with socket.create_connection(("127.0.0.1", native_server), 5) as s:
        fh = s.makefile("rwb")
        for line in (b'{"op": "fetch", "session": 42}\n',
                     b'{"op": "session", "dims": []}\n', b"garbage\n"):
            fh.write(line)
            fh.flush()
            assert json.loads(fh.readline())["status"] == "FAIL"


def test_two_sessions_isolated(native_server):
    with ServiceClient("127.0.0.1", native_server) as c1, \
            ServiceClient("127.0.0.1", native_server) as c2:
        s1 = c1.create_session([("a", list(range(5)))], strategy="brute")
        s2 = c2.create_session([("b", list(range(7)))], strategy="brute")
        assert s1 != s2
        p1, p2 = c1.generate(), c2.generate()
        c1.analyze(p1, 1.0)
        c2.analyze(p2, 2.0)
        assert c1.best() == list(p1) and c2.best() == list(p2)


def test_native_query_inform_cfg(native_server):
    with ServiceClient("127.0.0.1", native_server) as c:
        c.create_session([("x", list(range(10)))], strategy="random",
                         name="cfg-native", seed=7)
        assert c.query("SESSION_STRATEGY") == "random"
        assert c.query("RANDOM_SEED") == "7"
        assert c.query("NOPE") is None
        assert c.inform("PREFETCH_COUNT", 3) is None
        assert c.inform("PREFETCH_COUNT", "5") == "3"
        assert c.inform("PREFETCH_COUNT", None) == "5"
        assert c.query("PREFETCH_COUNT") is None
        assert c.inform("NOTE", 'say "hi"\\done') is None
        assert c.query("NOTE") == 'say "hi"\\done'
        c.inform("UNI", "µ-tab\tend")
        assert c.query("UNI") == "µ-tab\tend"
        c.inform("PAUSED", 1)
        r = c._rpc(op="fetch", session=c.session)
        assert r["status"] == "BUSY" and r["reason"] == "paused"
        c.inform("PAUSED", None)
        assert c.generate() is not None


def test_native_pause_resumes_search(native_server):
    with ServiceClient("127.0.0.1", native_server, pause_poll_s=0.05) as c:
        sid = c.create_session([("x", list(range(10)))], strategy="random",
                               name="pause-native")
        with ServiceClient("127.0.0.1", native_server) as admin:
            admin.join(sid)
            admin.inform("PAUSED", 1)
            got = []
            th = threading.Thread(target=lambda: got.append(c.generate()),
                                  daemon=True)
            th.start()
            time.sleep(0.3)
            assert got == []
            admin.inform("PAUSED", None)
            th.join(5.0)
            assert got and got[0] is not None


def test_python_service_entry_point():
    """``python -m offt_tpu_torch.tune.service`` serves the protocol on
    the port it is given."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "offt_tpu_torch.tune.service", "--port",
         str(port)], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True, cwd=os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    try:
        line = proc.stdout.readline()
        assert f":{port}" in line
        with ServiceClient("127.0.0.1", port) as c:
            c.create_session([("x", list(range(4)))], strategy="brute")
            assert c.generate() == (0,)
    finally:
        proc.kill()
        proc.wait()
