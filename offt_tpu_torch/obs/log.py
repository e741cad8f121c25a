"""Structured JSON-lines event log.

A copy of ``offt_tpu/obs/log.py`` (framework-free; the port imports
nothing of ``offt_tpu``). It replaces the reference's printf timing lines
and Active Harmony's per-session HTTP log of (timestamp, point, perf)
tuples (hserver.c:520-555) with an append-only JSONL stream any
dashboard can tail.
"""

from __future__ import annotations

import json
import os
import time
from typing import IO, Optional


class EventLog:
    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self.path = path
        self.echo = echo
        self._fh: Optional[IO] = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def emit(self, kind: str, **fields) -> dict:
        rec = {"t": round(time.time(), 6), "kind": kind, **fields}
        line = json.dumps(rec, default=str)
        if self._fh:
            self._fh.write(line + "\n")
        if self.echo:
            print(line)
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_events(path: str) -> list[dict]:
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    return out
