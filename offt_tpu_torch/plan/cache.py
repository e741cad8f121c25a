"""Persistent best-plan cache, in the reference's JSON format.

Port of ``offt_tpu/plan/cache.py``: one JSON file under
$OFFT_TPU_TORCH_CACHE_DIR (else the ``cache_dir`` config key, else
~/.cache/offt_tpu_torch), keyed by shape, dtype, transform kind, mesh
shape and device kind, where the device kind is
``torch.cuda.get_device_name()`` on the card ("cpu" on the host). The
reference's bundled ``tuned_defaults.json`` holds TPU device kinds only,
so the port ships none: a GPU key has no bundled hit.

Wisdom (FFTW's export/import, as the reference has it): ``export_wisdom``
writes the local cache to a file, ``import_wisdom`` merges one in, the
better measured time winning per key. A file exported by the reference
imports as it is; its keys name TPU device kinds, so no lookup on a card
or on the host ever matches them. ``python -m offt_tpu_torch.plan.cache
list|export FILE|import FILE|clear`` does the same from a shell.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import tempfile
from typing import Optional

import torch

from .params import PlanParams


def cache_dir() -> pathlib.Path:
    d = os.environ.get("OFFT_TPU_TORCH_CACHE_DIR")
    if not d:
        from ..utils import config as _cfg
        d = _cfg.get("cache_dir")
    if d:
        return pathlib.Path(d)
    return pathlib.Path(os.path.expanduser("~/.cache/offt_tpu_torch"))


def _cache_file() -> pathlib.Path:
    return cache_dir() / "plan_cache.json"


def device_kind(device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def plan_key(shape, dtype, real: bool, p1: int, p2: int,
             device_kind: str = "", batch: int = 1,
             inverse: bool = False, batch_sharded: bool = False) -> str:
    """Cache key; the same string the reference builds."""
    parts = [
        "x".join(map(str, shape)), str(dtype), "r2c" if real else "c2c",
        f"{p1}x{p2}", device_kind, f"b{batch}",
    ]
    if inverse:
        parts.append("inv")
    if batch_sharded:
        parts.append("bs")
    return "|".join(parts)


def _load() -> dict:
    f = _cache_file()
    if not f.exists():
        return {}
    try:
        return json.loads(f.read_text())
    except (json.JSONDecodeError, OSError):
        return {}


def _params_to_json(p: PlanParams) -> dict:
    d = dataclasses.asdict(p)
    for k in ("radix_z", "radix_y", "radix_x", "x_tile", "split_1d"):
        if d[k] is not None:
            d[k] = list(d[k])
    return d


def _params_from_json(d: dict) -> PlanParams:
    d = dict(d)
    for k in ("radix_z", "radix_y", "radix_x", "x_tile", "split_1d"):
        if d.get(k) is not None:
            d[k] = tuple(d[k])
    known = {f.name for f in dataclasses.fields(PlanParams)}
    return PlanParams(**{k: v for k, v in d.items() if k in known})


def lookup(key: str) -> Optional[PlanParams]:
    rec = _load().get(key)
    if rec is None:
        return None
    try:
        return _params_from_json(rec["params"])
    except (KeyError, TypeError):
        return None


def _write(db: dict) -> None:
    """Replace the cache file with ``db`` in one atomic rename, so that
    concurrent writers never leave a torn file."""
    d = cache_dir()
    d.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(db, fh, indent=1, sort_keys=True)
        os.replace(tmp, _cache_file())
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def store(key: str, params: PlanParams, perf: float | None = None) -> None:
    """Record ``params`` under ``key``, keeping a better-perf entry."""
    db = _load()
    old = db.get(key)
    if old is not None and perf is not None and old.get("perf") is not None:
        if old["perf"] <= perf:
            return
    db[key] = {"params": _params_to_json(params), "perf": perf}
    _write(db)


def clear() -> None:
    """Delete the local cache file."""
    try:
        _cache_file().unlink()
    except FileNotFoundError:
        pass


def export_wisdom(path) -> int:
    """Write the local cache to ``path``; returns its number of entries."""
    db = _load()
    pathlib.Path(path).write_text(json.dumps(db, indent=1, sort_keys=True))
    return len(db)


def import_wisdom(path) -> int:
    """Merge the entries of ``path`` into the local cache in one write;
    returns the number applied. An entry whose params do not parse is
    skipped; one that would replace a local entry must carry a better
    (smaller) measured time, so an entry without one only fills a missing
    key."""
    incoming = json.loads(pathlib.Path(path).read_text())
    db = _load()
    n = 0
    for key, rec in incoming.items():
        try:
            _params_from_json(rec["params"])
        except (KeyError, TypeError):
            continue
        old = db.get(key)
        if old is not None:
            new_perf = rec.get("perf")
            if new_perf is None or (old.get("perf") is not None
                                    and old["perf"] <= new_perf):
                continue
        db[key] = {"params": rec["params"], "perf": rec.get("perf")}
        n += 1
    if n:
        _write(db)
    return n


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m offt_tpu_torch.plan.cache",
        description="tuned-plan cache (wisdom) maintenance")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="print the cache's entries")
    pe = sub.add_parser("export", help="write the cache to FILE")
    pe.add_argument("file")
    pi = sub.add_parser("import", help="merge FILE into the cache")
    pi.add_argument("file")
    sub.add_parser("clear", help="delete the cache")
    ns = ap.parse_args(argv)
    if ns.cmd == "list":
        db = _load()
        for k, rec in sorted(db.items()):
            perf = rec.get("perf")
            perf_s = f"{perf * 1e3:.3f} ms" if perf else "-"
            print(f"local    {k}  perf={perf_s}")
        print(f"# {len(db)} local ({_cache_file()}), no bundled entries")
    elif ns.cmd == "export":
        print(f"exported {export_wisdom(ns.file)} entries -> {ns.file}")
    elif ns.cmd == "import":
        print(f"imported {import_wisdom(ns.file)} entries")
    elif ns.cmd == "clear":
        clear()
        print("cleared", _cache_file())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
