"""Dtype model of the PyTorch port.

Counterpart of ``paddle_tpu/core/dtype.py``: the canonical names usable
as ``paddle_tpu_torch.float32`` etc., here torch's own dtypes, and the
normalisation of a user dtype (a name, a numpy dtype, a torch dtype) to
one of them. ``to_jax_dtype`` has no counterpart (a JAX dtype).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "dtype",
    "is_floating",
    "is_integer",
    "is_complex",
    "default_float_dtype",
    "promote_types",
    "bool_",
    "uint8",
    "int8",
    "int16",
    "int32",
    "int64",
    "float16",
    "bfloat16",
    "float32",
    "float64",
    "complex64",
    "complex128",
]

# Canonical torch dtypes, exported under paddle-like names.
bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_NAME_TO_DTYPE = {
    "bool": bool_,
    "uint8": uint8,
    "int8": int8,
    "int16": int16,
    "int32": int32,
    "int64": int64,
    "float16": float16,
    "fp16": float16,
    "bfloat16": bfloat16,
    "bf16": bfloat16,
    "float32": float32,
    "fp32": float32,
    "float64": float64,
    "fp64": float64,
    "complex64": complex64,
    "complex128": complex128,
}


def dtype(dt):
    """Normalise a user dtype (a name, a numpy dtype or type, a torch
    dtype) to a torch dtype; None stays None."""
    if dt is None or isinstance(dt, torch.dtype):
        return dt
    if isinstance(dt, str):
        try:
            return _NAME_TO_DTYPE[dt]
        except KeyError:
            raise ValueError(f"unknown dtype name {dt!r}") from None
    npd = np.dtype(dt)
    if npd.name == "bfloat16":      # ml_dtypes' bfloat16, where installed
        return bfloat16
    try:
        return _NAME_TO_DTYPE[npd.name]
    except KeyError:
        raise ValueError(f"no torch dtype for {npd}") from None


def is_floating(dt) -> bool:
    return dtype(dt).is_floating_point


def is_integer(dt) -> bool:
    dt = dtype(dt)
    return not (dt.is_floating_point or dt.is_complex or dt == bool_)


def is_complex(dt) -> bool:
    return dtype(dt).is_complex


def default_float_dtype():
    from paddle_tpu_torch.core.flags import get_flag

    return dtype(get_flag("FLAGS_default_dtype"))


def promote_types(a, b):
    return torch.promote_types(dtype(a), dtype(b))
