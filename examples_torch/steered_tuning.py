"""Steering a live tuning session with query / inform.

The port of examples/steered_tuning.py, on the port's own tuning
service and client (offt_tpu_torch/tune/service.py, client.py): an
operator (or a supervising process) reads and writes a running
session's configuration without stopping the search, the Active Harmony
``harmony_query`` / ``harmony_inform`` workflow. A worker thread searches
the synthetic quadratic against an in-process tuning server while a
controller

  1. polls the live STRATEGY_CONVERGED key,
  2. pauses the session mid-search (fetch blocks, the worker waits),
  3. attaches an operator note, then un-pauses and lets it finish.

The objective is evaluated on the host; ``--device`` is checked like
every example's (the default, ``cuda``, needs a card), and nothing runs
on it. The server listens on 127.0.0.1 at a free port.

Run:  python examples_torch/steered_tuning.py [--device cpu]
"""

from __future__ import annotations

import threading
import time

from _common import device, parser

from offt_tpu_torch.tune.client import ServiceClient
from offt_tpu_torch.tune.service import TuningServer
from offt_tpu_torch.tune.synth import AH_OPTIMUM, ah_quadratic, \
    quadratic_space


def steer(trials: int = 200) -> dict:
    """One steered session: its best point, the note read back and the
    controller's readings."""
    srv = TuningServer(port=0)
    srv.start_background()
    try:
        dims = [(d.name, d.values) for d in quadratic_space().dims]
        worker = ServiceClient("127.0.0.1", srv.port, pause_poll_s=0.05)
        sid = worker.create_session(dims, strategy="nm", name="steered-demo")
        paused = threading.Event()

        def run_search():
            for _ in range(trials):
                pt = worker.generate()   # blocks while the session is paused
                if pt is None:
                    break
                if paused.is_set():
                    print("worker: resumed after pause")
                    paused.clear()
                worker.report(pt, ah_quadratic(pt))
            print(f"worker: done, best={worker.best()}")

        th = threading.Thread(target=run_search)
        th.start()
        ctl = ServiceClient("127.0.0.1", srv.port)
        ctl.join(sid)
        time.sleep(0.2)
        print("controller: converged =", ctl.query("STRATEGY_CONVERGED"))
        old = ctl.inform("PAUSED", "1")   # the previous value (None)
        print(f"controller: paused the session (old PAUSED={old})")
        paused.set()
        time.sleep(0.3)                   # the worker blocks in generate()
        note = "operator checkpoint at " + time.strftime("%H:%M")
        ctl.inform("NOTE", note)
        out = {"note": ctl.query("NOTE") == note,
               "paused": ctl.query("PAUSED")}
        ctl.inform("PAUSED", None)        # erase: un-pause
        out["unpaused"] = ctl.query("PAUSED")
        print("controller: un-paused; note =", ctl.query("NOTE"))
        th.join(timeout=60)
        out["alive"] = th.is_alive()
        out["best"] = worker.best()
        print("controller: final converged =",
              ctl.query("STRATEGY_CONVERGED"))
        worker.close()
        ctl.close()
    finally:
        srv.shutdown()
    return out


def main(argv=None) -> int:
    ns = parser(__doc__, trials=200).parse_args(argv)
    device(ns.device)
    r = steer(ns.trials)
    assert r["note"], "the note did not round-trip"
    assert r["paused"] == "1" and r["unpaused"] is None, r
    assert not r["alive"], "worker did not resume after un-pause"
    assert all(abs(b - o) <= 6 for b, o in zip(r["best"], AH_OPTIMUM)), r
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
