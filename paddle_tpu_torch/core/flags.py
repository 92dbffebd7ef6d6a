"""Typed global flags — the port of ``paddle_tpu/core/flags.py``.

One registry of ``FLAGS_*`` values. A flag is declared with
:func:`define_flag` (an environment variable of the same name, set when
the flag is declared, overrides its default), read with
:func:`get_flag`, set with :func:`set_flags` (paddle's
``paddle.set_flags({"FLAGS_...": v})``) and read in bulk with
:func:`get_flags` and :func:`flags_snapshot`. Strings are coerced to the
flag's type as the reference coerces them.

Only the flags a ported module reads are declared: the three of the
fault-tolerance machinery (``distributed/resilience.py`` and
``distributed/checkpoint.py``).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

__all__ = ["define_flag", "get_flag", "set_flags", "get_flags",
           "flags_snapshot"]

_TRUE_STRINGS = frozenset({"1", "true", "yes", "on"})
_FALSE_STRINGS = frozenset({"0", "false", "no", "off", ""})


def _parse_bool(text: str) -> bool:
    low = text.strip().lower()
    if low in _TRUE_STRINGS:
        return True
    if low in _FALSE_STRINGS:
        return False
    raise ValueError(f"cannot parse {text!r} as bool")


@dataclass
class _FlagSpec:
    name: str
    default: Any
    dtype: type
    help: str
    validator: Optional[Callable[[Any], bool]] = None


class _FlagRegistry:
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._specs: Dict[str, _FlagSpec] = {}
        self._values: Dict[str, Any] = {}

    def define(self, name, default, dtype=None, help="", validator=None):
        with self._lock:
            if name in self._specs:
                raise KeyError(f"flag {name!r} already defined")
            spec = _FlagSpec(name, default, dtype or type(default), help,
                             validator)
            self._specs[name] = spec
            env = os.environ.get(name)
            value = default if env is None else self._coerce(spec, env)
            self._values[name] = value
            return value

    def _coerce(self, spec: _FlagSpec, raw: Any) -> Any:
        if isinstance(raw, str) and spec.dtype is not str:
            raw = (_parse_bool(raw) if spec.dtype is bool
                   else spec.dtype(raw))
        elif not isinstance(raw, spec.dtype):
            if spec.dtype is float and isinstance(raw, int):
                raw = float(raw)
            elif spec.dtype is bool and isinstance(raw, int):
                raw = bool(raw)
            else:
                raise TypeError(
                    f"flag {spec.name} expects {spec.dtype.__name__}, "
                    f"got {type(raw).__name__}")
        if spec.validator is not None and not spec.validator(raw):
            raise ValueError(f"invalid value {raw!r} for flag {spec.name}")
        return raw

    def get(self, name: str) -> Any:
        with self._lock:
            if name not in self._specs:
                raise KeyError(f"unknown flag {name!r}")
            return self._values[name]

    def set(self, name: str, value: Any) -> None:
        with self._lock:
            if name not in self._specs:
                raise KeyError(f"unknown flag {name!r}")
            self._values[name] = self._coerce(self._specs[name], value)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._values)


_REGISTRY = _FlagRegistry()


def define_flag(name, default, dtype=None, help="", validator=None):
    """Declare a global flag; the env var of the same name overrides the
    default."""
    return _REGISTRY.define(name, default, dtype=dtype, help=help,
                            validator=validator)


def get_flag(name: str) -> Any:
    return _REGISTRY.get(name)


def set_flags(flags: Dict[str, Any]) -> None:
    """Paddle-compatible ``set_flags({"FLAGS_x": v, ...})``."""
    for name, value in flags.items():
        _REGISTRY.set(name, value)


def get_flags(names) -> Dict[str, Any]:
    if isinstance(names, str):
        names = [names]
    return {n: _REGISTRY.get(n) for n in names}


def flags_snapshot() -> Dict[str, Any]:
    return _REGISTRY.snapshot()


# -- fault tolerance (distributed/resilience.py, distributed/checkpoint.py) --
define_flag("FLAGS_io_max_retries", 3,
            help="Retry budget for transient checkpoint IO and host-barrier "
                 "failures (jittered exponential backoff between attempts).")
define_flag("FLAGS_io_backoff_base_ms", 50,
            help="Base delay (ms) of the jittered exponential backoff used "
                 "by resilience retries; attempt i waits ~base * 2^i.")
define_flag("FLAGS_ckpt_verify", True,
            help="Verify per-shard checksums when loading a checkpoint "
                 "(corruption is detected at restore instead of as garbage "
                 "parameters mid-run).")

# -- dtype defaults (core/dtype.py default_float_dtype) ------------------------
define_flag("FLAGS_default_dtype", "float32",
            help="Default floating dtype for new tensors.")
