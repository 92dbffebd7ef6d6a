"""``paddle_tpu_torch.device`` — device management namespace.

Counterpart of ``paddle_tpu/device/__init__.py``: ``set_device``,
``get_device``, ``device_count`` and ``is_compiled_with_tpu`` from
``core/place.py``, the ``cuda`` submodule's allocator counters, and
``synchronize`` (``torch.cuda.synchronize``).
"""

from paddle_tpu_torch.core.place import (  # noqa: F401
    device_count,
    get_device,
    is_compiled_with_tpu,
    set_device,
)
from paddle_tpu_torch.device import cuda  # noqa: F401

__all__ = ["set_device", "get_device", "device_count", "cuda",
           "is_compiled_with_tpu", "synchronize"]


def synchronize(device=None):
    """Block until all queued work of the card completes (nothing to wait
    for on a host without one)."""
    import torch

    if torch.cuda.is_available():
        from paddle_tpu_torch.core.memory import _device

        torch.cuda.synchronize(_device(device))
