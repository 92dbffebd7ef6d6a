"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

A second package beside the JAX one, mirroring its module paths
(``models/gpt.py``, ``inference/serving.py``, ...). It imports torch and
numpy only — never JAX, never ``paddle_tpu`` — so it runs on a host with
an NVIDIA card and no JAX installed. Every Pallas kernel on a ported
path becomes a CUDA C++ kernel for Hopper (``csrc/``), built at first use
and launched through a wrapper that keeps the kernel's plain PyTorch
version beside it: CPU tensors take the plain version, CUDA tensors the
kernel.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``.

Slice 1 ports paged GPT serving: ``ServingEngine`` over the paged KV
block pool with the LayerNorm, paged-decode and chunk-prefill kernels.
"""

from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.core.random import seed

__version__ = "0.1.0"

__all__ = ["resolve_device", "seed", "__version__"]
