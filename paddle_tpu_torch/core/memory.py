"""Device memory statistics of the PyTorch port.

Counterpart of ``paddle_tpu/core/memory.py`` (the reference's allocator
stat surface, ``paddle.device.cuda.max_memory_allocated`` and the rest):
here the counters are torch's CUDA caching allocator's. ``Allocated`` is
the bytes held by live tensors, ``Reserved`` the bytes the allocator
holds from the driver. On a host without a card every counter reads 0
and ``memory_stats`` an empty dict, as the reference's CPU backend
reports.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["memory_allocated", "max_memory_allocated", "memory_reserved",
           "max_memory_reserved", "memory_stats", "device_count",
           "empty_cache"]


def _device(device: Union[None, int, str, torch.device] = None):
    """The card a query names: None the current one, an index, ``"gpu:i"``
    (the reference's form) or a torch device; None if the host has no
    card."""
    if not torch.cuda.is_available():
        return None
    if device is None or isinstance(device, int):
        return torch.device("cuda", torch.cuda.current_device()
                            if device is None else device)
    if isinstance(device, str):
        platform, _, idx = device.partition(":")
        if platform in ("gpu", "cuda"):
            return torch.device("cuda", int(idx) if idx else 0)
        return None
    return device


def memory_stats(device=None) -> dict:
    """Raw allocator counters (an empty dict on a host without a card)."""
    d = _device(device)
    return {} if d is None else dict(torch.cuda.memory_stats(d))


def memory_allocated(device=None) -> int:
    """Bytes currently allocated on the device."""
    d = _device(device)
    return 0 if d is None else int(torch.cuda.memory_allocated(d))


def max_memory_allocated(device=None) -> int:
    """High-water mark of allocated bytes."""
    d = _device(device)
    return 0 if d is None else int(torch.cuda.max_memory_allocated(d))


def memory_reserved(device=None) -> int:
    """Bytes reserved by the caching allocator."""
    d = _device(device)
    return 0 if d is None else int(torch.cuda.memory_reserved(d))


def max_memory_reserved(device=None) -> int:
    d = _device(device)
    return 0 if d is None else int(torch.cuda.max_memory_reserved(d))


def device_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def empty_cache() -> None:
    """Return the caching allocator's unused blocks to the driver (after
    a garbage collection, so tensors only a cycle held are freed too)."""
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
