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
Slice 2 ports GPT training on one card: ``GPTForCausalLM(ids, labels)``,
paddle's AMP (``amp``), ``Adam``/``AdamW`` (``optimizer``) and
``distributed.ShardedTrainer``, with the flash-attention forward and
backward kernels. Slice 13 adds the rest of the one-card training loop:
``optimizer.lr`` schedulers, ``nn`` gradient clipping,
``amp.GradScaler`` and ``amp.decorate`` (O2) with master weights,
recompute (``distributed.fleet.utils``), attention dropout and the
cross-entropy variants; the flash kernels take float16 too. Slice 15
adds fault-tolerant training on one card: ``distributed.checkpoint``
(the reference's on-disk format), ``distributed.resilience``
(``CheckpointManager``, the anomaly policy), ``DistributedStrategy``
with gradient merge, ``testing.fault_injection`` and the ``FLAGS_*``
registry (``set_flags``/``get_flags``).
"""

from paddle_tpu_torch.core.flags import get_flags, set_flags
from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.core.random import seed

__version__ = "0.1.0"

__all__ = ["resolve_device", "seed", "set_flags", "get_flags",
           "__version__"]
