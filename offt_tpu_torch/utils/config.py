"""Layered configuration: defaults < config file < environment < kwargs.

Port of ``offt_tpu/utils/config.py``: the tuner's keys (``strategy``,
``max_trials``, ``simplex_size``, ``prefetch_count``, ``server_host``,
``server_port``) and the plan's (``precision``, ``use_pallas``,
``cache_dir``). The file is JSON at $OFFT_TPU_TORCH_CONFIG (default
~/.config/offt_tpu_torch/config.json); any key can be overridden by an
OFFT_TPU_TORCH_<KEY> environment variable.
"""

from __future__ import annotations

import json
import os
import pathlib
from typing import Any

DEFAULTS: dict[str, Any] = {
    # tuning (Active Harmony's defaults.h analogues)
    "strategy": "nm",
    "max_trials": 30,
    "simplex_size": 0,            # 0 = ndims + 1
    "prefetch_count": 4,          # the Tuner's batch (PREFETCH_COUNT)
    "server_host": "127.0.0.1",
    "server_port": 1979,
    # "auto" resolves in plan.params.default_params; every precision value
    # computes at f32 on the card (see PlanParams)
    "precision": "auto",
    "use_pallas": -1,             # -1 = auto (every axis kernel-expressible)
    "cache_dir": "",              # "" = ~/.cache/offt_tpu_torch
}


def _config_path() -> pathlib.Path:
    p = os.environ.get("OFFT_TPU_TORCH_CONFIG")
    if p:
        return pathlib.Path(p)
    return pathlib.Path(
        os.path.expanduser("~/.config/offt_tpu_torch/config.json"))


def _load_file() -> dict:
    f = _config_path()
    if not f.exists():
        return {}
    try:
        data = json.loads(f.read_text())
        return {str(k).lower(): v for k, v in data.items()}
    except (json.JSONDecodeError, OSError):
        return {}


def get(key: str, default: Any = None, **overrides) -> Any:
    """Resolve a config key through all layers (case-insensitive)."""
    key = key.lower()
    if key in overrides and overrides[key] is not None:
        return overrides[key]
    env = os.environ.get(f"OFFT_TPU_TORCH_{key.upper()}")
    if env is not None:
        base = DEFAULTS.get(key, default)
        if isinstance(base, int):
            try:
                return int(env)
            except ValueError:
                pass
        return env
    fromfile = _load_file().get(key)
    if fromfile is not None:
        return fromfile
    return DEFAULTS.get(key, default)


def snapshot(**overrides) -> dict[str, Any]:
    """Every key resolved through the layers (for logs and
    reproducibility)."""
    return {k: get(k, **overrides) for k in DEFAULTS}
