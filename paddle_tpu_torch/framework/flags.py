"""Global flags (counterpart of ``paddle_tpu/framework/flags.py``):
``paddle.set_flags`` / ``get_flags``, initialised from ``FLAGS_*``
environment variables as paddle's are."""
from __future__ import annotations

import os
from typing import Any

__all__ = ["define_flag", "set_flags", "get_flags"]

_FLAGS: dict[str, Any] = {}


def _coerce(default, raw: str):
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


def define_flag(name: str, default, help_str: str = ""):
    env = os.environ.get(name)
    _FLAGS[name] = _coerce(default, env) if env is not None else default


def set_flags(flags: dict):
    for k, v in flags.items():
        if k not in _FLAGS:
            raise ValueError(f"unknown flag {k!r}")
        _FLAGS[k] = v


def get_flags(flags) -> dict:
    if isinstance(flags, str):
        flags = [flags]
    out = {}
    for k in flags:
        if k not in _FLAGS:
            raise ValueError(f"unknown flag {k!r}")
        out[k] = _FLAGS[k]
    return out


define_flag("FLAGS_check_nan_inf", False, "scan op outputs for NaN/Inf (debug)")
define_flag("FLAGS_check_nan_inf_level", 0, "0: error on nan/inf; higher: warn")
