"""``paddle_tpu_torch.framework`` — ``save`` and ``load``
(``paddle_tpu/framework/__init__.py``)."""

from paddle_tpu_torch.framework.io import load, save  # noqa: F401
