"""``paddle.save`` / ``paddle.load`` of the PyTorch port.

Counterpart of ``paddle_tpu/framework/io.py``, on the same on-disk
model: a (possibly nested) object pickled, each tensor a numpy payload
(``_TensorPayload``: the array, a name, ``stop_gradient``), an object
with ``state_dict()`` saved as its state dict.

The two frameworks read each other's files, and the port imports
neither JAX nor ``paddle_tpu`` to do so:

- A payload is pickled under the reference's class path,
  ``paddle_tpu.framework.io._TensorPayload`` (the port writes the
  opcodes that name it; pickle would import the module to check it), and
  the port's unpickler maps that path to its own class.
- bf16. The reference's bf16 payload is an ``ml_dtypes.bfloat16`` numpy
  array, which pickles as ``numpy.dtype(ml_dtypes.bfloat16)`` beside the
  array's raw bytes. The port writes a bf16 tensor the same way: its
  two-byte bit patterns under a dtype that names
  ``ml_dtypes.bfloat16``, so the reference (which has ``ml_dtypes``)
  reads a bf16 array. The port's unpickler never imports ``ml_dtypes``
  (the card's machine may lack it): that dtype becomes numpy's raw
  two-byte ``'<V2'``, read through int16 as ``distributed/checkpoint.py``
  reads it, back to a bf16 tensor (``return_numpy=True`` gives the
  ``'<V2'`` array).

``load`` places tensors on the default place (``set_device``).
"""

from __future__ import annotations

import io
import os
import pickle
from typing import Any

import numpy as np
import torch

__all__ = ["save", "load"]

_PROTOCOL = 4
_REF_PAYLOAD = ("paddle_tpu.framework.io", "_TensorPayload")
_REF_BF16 = ("ml_dtypes", "bfloat16")


class _TensorPayload:
    """Pickle-stable wrapper marking arrays that were tensors."""

    __slots__ = ("array", "name", "stop_gradient")

    def __init__(self, array, name, stop_gradient):
        self.array = array
        self.name = name
        self.stop_gradient = stop_gradient


class _Bf16Type:
    """Stands for ``ml_dtypes.bfloat16`` in a pickle stream: written as
    that global, read back as this class."""


class _Bf16Dtype:
    """A bf16 array's dtype in the stream the port writes: the reduce
    that ``numpy.dtype(ml_dtypes.bfloat16)`` pickles to."""

    def __reduce__(self):
        # (version, byte order, subarray, names, fields, itemsize,
        # alignment, flags) of ml_dtypes' bfloat16 descriptor
        return (np.dtype, (_Bf16Type, False, True),
                (3, "<", None, None, None, 2, 2, 64))


class _Bf16Array:
    """A bf16 tensor's bits (a uint16 numpy array) pickled as a numpy
    array of ``ml_dtypes.bfloat16``."""

    def __init__(self, bits: np.ndarray):
        self.bits = np.ascontiguousarray(bits)

    def __reduce__(self):
        fn, args, state = self.bits.__reduce__()
        version, shape, _, fortran, raw = state
        return fn, args, (version, shape, _Bf16Dtype(), fortran, raw)


class _Pickler(pickle._Pickler):
    """The pure-Python pickler with two globals written by name: the
    reference's payload class and ``ml_dtypes.bfloat16``, neither of
    which the port imports."""

    def save_global(self, obj, name=None):
        path = {_TensorPayload: _REF_PAYLOAD, _Bf16Type: _REF_BF16}.get(obj)
        if path is None:
            return super().save_global(obj, name)
        if self.proto >= 4:
            self.save(path[0])
            self.save(path[1])
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{path[0]}\n{path[1]}\n".encode())
        self.memoize(obj)


def _make_dtype(obj, align=False, copy=False):
    """``numpy.dtype`` of an unpickled stream: ``ml_dtypes.bfloat16``
    becomes the raw two-byte ``'<V2'`` (its descriptor's state then
    applies to it unchanged)."""
    if obj is _Bf16Type:
        return np.dtype("V2")
    return np.dtype(obj, align, copy)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == _REF_PAYLOAD or (
                module == __name__ and name == "_TensorPayload"):
            return _TensorPayload
        if (module, name) == _REF_BF16:
            return _Bf16Type
        if (module, name) == ("numpy", "dtype"):
            return _make_dtype
        return super().find_class(module, name)


def _array_of(t: torch.Tensor):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return _Bf16Array(t.contiguous().view(torch.int16).numpy()
                          .view(np.uint16))
    return t.numpy()


def _tensor_of(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:    # bf16 bits
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def _to_serializable(obj):
    if isinstance(obj, torch.Tensor):
        return _TensorPayload(_array_of(obj), getattr(obj, "name", None),
                              not obj.requires_grad)
    if isinstance(obj, dict):
        return {k: _to_serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_serializable(v) for v in obj)
    if hasattr(obj, "state_dict") and callable(obj.state_dict):
        return _to_serializable(obj.state_dict())
    return obj


def _from_serializable(obj, return_numpy: bool, device):
    if isinstance(obj, _TensorPayload):
        if return_numpy:
            return obj.array
        t = _tensor_of(obj.array).to(device)
        return t.requires_grad_(not obj.stop_gradient
                                and t.is_floating_point())
    if isinstance(obj, dict):
        return {k: _from_serializable(v, return_numpy, device)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_serializable(v, return_numpy, device)
                         for v in obj)
    return obj


def save(obj: Any, path: str, protocol: int = _PROTOCOL, **configs):
    """``paddle.save``: pickle a (possibly nested) object, converting
    tensors to numpy payloads (bf16 as ``ml_dtypes.bfloat16`` arrays, as
    the reference writes them)."""
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    payload = _to_serializable(obj)
    buf = io.BytesIO()
    _Pickler(buf, protocol=protocol).dump(payload)
    with open(path, "wb") as f:
        f.write(buf.getbuffer())


def load(path: str, return_numpy: bool = False, **configs) -> Any:
    """``paddle.load``: inverse of :func:`save`, and the reader of the
    reference's files. Tensors land on the default place
    (``set_device``); with ``return_numpy=True`` they stay numpy arrays
    (bf16 as ``'<V2'`` bit patterns)."""
    from paddle_tpu_torch.core.place import resolve_device

    device = None if return_numpy else resolve_device()
    with open(path, "rb") as f:
        payload = _Unpickler(f).load()
    return _from_serializable(payload, return_numpy, device)
