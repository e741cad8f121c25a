"""Client for the tuning service — the hclient API re-expression
(activeharmony/build/hclient.c: harmony_init/bind/join/
fetch/report/best/converged over TCP); a copy of
``offt_tpu/tune/client.py``.

Implements the same Strategy protocol as local strategies, so the Tuner
loop can run against a remote service transparently; also usable directly:

    c = ServiceClient("localhost", 1979)
    sid = c.create_session([("x", list(range(1, 101)))], strategy="nm")
    pt = c.fetch()
    c.report(pt, measure(...))
"""

from __future__ import annotations

import json
import socket
import time
from typing import Optional


class ServiceClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 1979,
                 timeout: float = 30.0, pause_poll_s: float = 0.5):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._fh = self._sock.makefile("rwb")
        self.session: Optional[int] = None
        self._last_point = None
        # retry interval while the session is operator-PAUSED (fetch
        # returns BUSY/paused); a pause is temporary by contract, so
        # generate() blocks through it instead of ending the search
        self.pause_poll_s = pause_poll_s

    def _rpc(self, **msg) -> dict:
        self._fh.write((json.dumps(msg) + "\n").encode())
        self._fh.flush()
        line = self._fh.readline()
        if not line:
            raise ConnectionError("tuning service closed the connection")
        reply = json.loads(line)
        if reply.get("status") == "FAIL":
            raise RuntimeError(f"service error: {reply.get('error')}")
        return reply

    def create_session(self, dims, strategy: str = "nm", name: str = "",
                       seed: int = 0) -> int:
        reply = self._rpc(op="session", name=name or "offt-tune",
                          dims=[{"name": n, "values": list(v)}
                                for n, v in dims],
                          strategy=strategy, seed=seed)
        self.session = reply["session"]
        return self.session

    def join(self, session: int):
        self.session = session

    # ---- Strategy protocol (generate/analyze/rejected/best/converged) ---
    def generate(self, wait_timeout_s: float = 600.0):
        """Fetch the next candidate point, blocking through temporary
        BUSY states: "paused" (operator pause — unbounded by contract)
        and "waiting" (the strategy is blocked on another client's
        outstanding report, the multi-client mid-round state — bounded
        by ``wait_timeout_s`` so a crashed sibling cannot hang us
        forever). Returns None when the search is over."""
        t0 = time.monotonic()
        while True:
            reply = self._rpc(op="fetch", session=self.session)
            if reply.get("status") != "BUSY":
                break
            reason = reply.get("reason")
            if reason == "paused":
                time.sleep(self.pause_poll_s)  # temporary: wait it out
                continue
            if reason == "waiting":
                if time.monotonic() - t0 > wait_timeout_s:
                    return None
                time.sleep(self.pause_poll_s)
                continue
            return None  # exhausted (or a legacy server): search is over
        self._last_point = tuple(reply["point"])
        return self._last_point

    fetch = generate

    def analyze(self, point, perf: float):
        self._rpc(op="report", session=self.session,
                  point=list(point), perf=float(perf))

    report = analyze

    def rejected(self, point):
        self._rpc(op="reject", session=self.session, point=list(point))

    def best(self):
        reply = self._rpc(op="best", session=self.session)
        return reply.get("values")

    def converged(self) -> bool:
        return bool(self._rpc(op="converged",
                              session=self.session).get("converged"))

    # ---- runtime config (harmony_query/harmony_inform, hclient.h:95-128) -
    def query(self, key: str) -> Optional[str]:
        """Read a session config key (None if unset). The live key
        STRATEGY_CONVERGED reflects the strategy state server-side."""
        return self._rpc(op="getcfg", session=self.session,
                         key=str(key)).get("value")

    def inform(self, key: str, value) -> Optional[str]:
        """Write (or, with value=None, erase) a session config key;
        returns the original value. Setting PAUSED=1 makes fetch return
        BUSY until it is erased or set to 0."""
        return self._rpc(op="setcfg", session=self.session, key=str(key),
                         value=None if value is None else str(value)
                         ).get("old")

    def close(self):
        try:
            self._rpc(op="leave", session=self.session)
        except Exception:
            pass
        self._fh.close()
        self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
