"""Trial-log viewer: summarize a JSONL tuning log in the terminal.

A copy of ``offt_tpu/obs/view.py`` (framework-free). The offline
counterpart of the live HTTP monitor (the reference serves flot charts
from hserver's in-memory log, httpsvr.c; these logs are durable JSONL
files, so post-hoc analysis works too).

Usage:  python -m offt_tpu_torch.obs.view /path/to/trials.jsonl [--top N]
"""

from __future__ import annotations

import argparse
import json
import sys

from .log import read_events


def summarize(path: str, top: int = 5) -> dict:
    events = read_events(path)
    trials = [e for e in events if e.get("kind") == "trial"]
    ok = [e for e in trials if e.get("status") == "ok"]
    dup = [e for e in trials if e.get("status") == "duplicate"]
    infeasible = [e for e in trials if e.get("status") == "infeasible"]
    errors = [e for e in events if e.get("kind") == "trial_error"]
    done = next((e for e in events if e.get("kind") == "tune_done"), None)
    measured = sorted((e for e in ok if e.get("perf") not in (None,)),
                      key=lambda e: e["perf"])
    return {
        "events": len(events),
        "trials": len(trials),
        "ok": len(ok),
        "duplicates": len(dup),
        "infeasible": len(infeasible),
        "errors": len(errors),
        "best": measured[:top],
        "done": done,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="offt-tune-view")
    ap.add_argument("log")
    ap.add_argument("--top", type=int, default=5)
    ap.add_argument("--json", action="store_true")
    ns = ap.parse_args(argv)
    s = summarize(ns.log, ns.top)
    if ns.json:
        print(json.dumps(s))
        return 0
    print(f"{ns.log}: {s['trials']} trials "
          f"({s['ok']} ok, {s['duplicates']} dup, "
          f"{s['infeasible']} infeasible, {s['errors']} errors)")
    if s["best"]:
        print(f"top {len(s['best'])} measured points:")
        for e in s["best"]:
            print(f"  {e['perf'] * 1e3:9.3f} ms  point={e['point']}")
    if s["done"]:
        d = s["done"]
        bp = d.get("best_perf")
        dp = d.get("default_perf")
        line = "tune_done:"
        if bp is not None:
            line += f" best={bp * 1e3:.3f} ms"
        if dp not in (None, float("inf")) and bp:
            line += f" default={dp * 1e3:.3f} ms speedup={dp / bp:.3f}x"
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
