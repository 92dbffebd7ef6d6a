"""Device resolution for the PyTorch port.

Counterpart of ``paddle_tpu/core/place.py``. The port's entry points run
on the card unless the caller asks for the CPU: ``resolve_device()``
defaults to ``"cuda"`` and raises a clear error on a host without one.
Nothing falls back to the CPU on its own — a caller that wants the CPU
(the tests do) passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device", "module_device"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """Turn ``device`` (default ``"cuda"``) into a ``torch.device``.

    A CUDA device on a host where ``torch.cuda.is_available()`` is false
    raises ``RuntimeError`` naming the explicit ``device="cpu"`` opt-in,
    rather than silently running somewhere else."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested (the default) but no CUDA device "
            "is available on this host; pass device='cpu' explicitly to "
            "run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!s}: use 'cuda' or 'cpu'")
    return dev


def module_device(module: torch.nn.Module) -> torch.device:
    """The device a module's parameters live on (they must agree). Not
    the reference's ``get_device()``, which names the current place and
    arrives with ``device/``."""
    devs = {p.device for p in module.parameters()}
    if len(devs) != 1:
        raise ValueError(f"module parameters span devices {sorted(map(str, devs))}")
    return devs.pop()
