"""Reference parameters the port does not implement yet.

The port's public callables take the reference's positional parameters
in the reference's order and under its names, so a positional call binds
what it binds in ``paddle_tpu``; the port's own parameters (``device``,
``dtype``, a ``seed`` the reference lacks) are keyword-only. A reference
parameter the port does not implement is accepted at its reference
default only: :func:`refuse_unported` raises ``NotImplementedError``
naming it otherwise, so a call that relies on it never runs as if it
had been honoured.
"""

from __future__ import annotations

from typing import Any, Tuple

__all__ = ["refuse_unported"]


def _is_default(value, default) -> bool:
    if default is None:
        return value is None
    return value is default or (type(value) is type(default)
                                and value == default)


def refuse_unported(owner: str, **given: Tuple[Any, Any]) -> None:
    """Raise ``NotImplementedError`` for the first ``name=(value,
    default)`` of ``given`` whose value is not the reference default."""
    for name, (value, default) in given.items():
        if not _is_default(value, default):
            raise NotImplementedError(
                f"{owner}: {name}={value!r} is not ported yet; only the "
                f"reference default {name}={default!r} is accepted")
