"""``paddle_tpu_torch.device.cuda`` — the card's memory counters and
``synchronize`` under the reference's name
(``paddle_tpu/device/cuda.py``), on torch's CUDA caching allocator
(``core/memory.py``)."""

from paddle_tpu_torch.core.memory import (  # noqa: F401
    device_count,
    empty_cache,
    max_memory_allocated,
    max_memory_reserved,
    memory_allocated,
    memory_reserved,
)

__all__ = ["device_count", "empty_cache", "max_memory_allocated",
           "max_memory_reserved", "memory_allocated", "memory_reserved",
           "synchronize"]


def synchronize(device=None):
    from paddle_tpu_torch.device import synchronize as _sync

    return _sync(device)
