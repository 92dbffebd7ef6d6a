"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

A second package beside the JAX one, mirroring its module paths
(``models/gpt.py``, ``inference/serving.py``, ...). It imports torch and
numpy only — never JAX, never ``paddle_tpu`` — so it runs on a host with
an NVIDIA card and no JAX installed. Every Pallas kernel on a ported
path becomes a CUDA C++ kernel for Hopper (``csrc/``), built at first use
and launched through a wrapper that keeps the kernel's plain PyTorch
version beside it: CPU tensors take the plain version, CUDA tensors the
kernel.

The top-level namespace mirrors ``paddle_tpu``'s (``import
paddle_tpu_torch as paddle``): the places and ``set_device``, the dtypes
(torch's own), the tensor API (``Tensor`` is ``torch.Tensor``), the op
library the port has, ``grad``, ``save``/``load``, ``ParamAttr``, and
the subpackages (``nn``, ``optimizer``, ``amp``, ``distributed``,
``models``, ``inference``, ...) imported on first use. What the port
lacks yet is listed, name by name with its reason, in
``tests/test_torch_signatures.py`` (``ABSENT_TOP``).

Entry points run on the default place, ``gpu:0``, unless the caller
passes ``device="cpu"`` or opts in for the process with
``set_device("cpu")``; on a host without a card they raise rather than
run elsewhere.
"""

__version__ = "0.1.0"

# -- core -------------------------------------------------------------------
from paddle_tpu_torch.core import memory  # noqa: F401
from paddle_tpu_torch.core.flags import get_flags, set_flags  # noqa: F401
from paddle_tpu_torch.core.place import (  # noqa: F401
    CPUPlace,
    CUDAPinnedPlace,
    CUDAPlace,
    CustomPlace,
    GPUPlace,
    NPUPlace,
    Place,
    TPUPlace,
    device_count,
    get_device,
    is_compiled_with_tpu,
    resolve_device,
    set_device,
)
from paddle_tpu_torch.core.random import seed  # noqa: F401
from paddle_tpu_torch.core.dtype import (  # noqa: F401
    bfloat16,
    bool_ as bool,  # noqa: A001
    complex64,
    complex128,
    dtype,
    float16,
    float32,
    float64,
    int8,
    int16,
    int32,
    int64,
    uint8,
)
from paddle_tpu_torch.core.tensor import (  # noqa: F401
    Parameter,
    Tensor,
    enable_grad,
    is_grad_enabled,
    no_grad,
    to_tensor,
)

# -- ops (flat namespace like paddle.*) -------------------------------------
from paddle_tpu_torch.ops import *  # noqa: F401,F403

# -- autograd ---------------------------------------------------------------
from paddle_tpu_torch.core import autograd as _autograd_core


def grad(*args, **kwargs):
    return _autograd_core.grad(*args, **kwargs)


# -- subpackages (imported lazily to keep import light) ---------------------
import importlib as _importlib

_LAZY_SUBMODULES = (
    "nn",
    "optimizer",
    "amp",
    "distributed",
    "incubate",
    "models",
    "framework",
    "inference",
    "device",
    "observability",
    "testing",
    "regularizer",
)


def __getattr__(name):
    if name == "DataParallel":
        from paddle_tpu_torch.distributed.parallel import DataParallel

        globals()[name] = DataParallel
        return DataParallel
    if name in _LAZY_SUBMODULES:
        module = _importlib.import_module(f"paddle_tpu_torch.{name}")
        globals()[name] = module
        return module
    raise AttributeError(f"module 'paddle_tpu_torch' has no attribute "
                         f"{name!r}")


def save(obj, path, **kwargs):
    from paddle_tpu_torch.framework.io import save as _save

    return _save(obj, path, **kwargs)


def load(path, **kwargs):
    from paddle_tpu_torch.framework.io import load as _load

    return _load(path, **kwargs)


def is_grad_enabled_():  # legacy alias
    return is_grad_enabled()


from paddle_tpu_torch.nn.layer import ParamAttr  # noqa: F401,E402
