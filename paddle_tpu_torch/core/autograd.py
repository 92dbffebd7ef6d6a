"""``paddle.grad`` of the PyTorch port (``paddle_tpu/core/autograd.py``).

The port's tensors are torch tensors on torch's own tape, so of the
reference's autograd engine only its partial-gradient entry point has a
counterpart here, on ``torch.autograd.grad``.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["grad"]


def grad(
    outputs,
    inputs,
    grad_outputs=None,
    retain_graph: Optional[bool] = None,
    create_graph: bool = False,
    allow_unused: bool = False,
):
    """Gradients of ``outputs`` with respect to ``inputs`` as a list,
    without touching any ``.grad``. ``retain_graph`` defaults to
    ``create_graph``; ``create_graph=True`` gives gradients that can be
    differentiated again; an input that receives no gradient raises
    unless ``allow_unused``, which gives None for it."""
    if isinstance(outputs, torch.Tensor):
        outputs = [outputs]
    if isinstance(inputs, torch.Tensor):
        inputs = [inputs]
    if isinstance(grad_outputs, torch.Tensor):
        grad_outputs = [grad_outputs]
    if retain_graph is None:
        retain_graph = create_graph
    return list(torch.autograd.grad(
        outputs, inputs, grad_outputs=grad_outputs,
        retain_graph=retain_graph, create_graph=create_graph,
        allow_unused=allow_unused))
