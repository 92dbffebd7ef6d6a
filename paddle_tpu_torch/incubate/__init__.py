"""``paddle_tpu_torch.incubate``: experimental APIs of
``paddle_tpu/incubate/``. ``asp`` (2:4 structured sparsity) is ported;
the fused layers and MoE under ``nn/`` and ``distributed/`` are not."""

from paddle_tpu_torch.incubate import asp

__all__ = ["asp"]
