"""Seeded random generators for the PyTorch port.

Counterpart of ``paddle_tpu/core/random.py``. JAX threads one functional
key through the program; PyTorch draws from explicit
``torch.Generator`` objects instead:

- one generator per engine or per model build (:func:`generator`),
  seeded by the caller;
- one generator per serving request (:func:`request_generator`), seeded
  from ``Request.seed`` when set, else from the engine seed and the
  request id. The serving engine draws exactly one uniform from it per
  committed sampled token, so a request's stream never depends on what
  its neighbours do, and a preempted request resumes on the same stream.

The two frameworks give different numbers from the same seed: parity
tests hold sampling to its distribution, and greedy decoding (which
draws nothing) to exact tokens.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

__all__ = ["seed", "generator", "request_seed", "request_generator"]


def seed(value: int) -> torch.Generator:
    """``paddle.seed`` counterpart: seed torch's default generators and
    return the default CPU generator."""
    return torch.manual_seed(int(value))


def generator(seed: int, device: Union[str, torch.device] = "cpu"
              ) -> torch.Generator:
    """A fresh generator on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g


def request_seed(engine_seed: int, request_id: int,
                 seed: Optional[int] = None) -> int:
    """The seed of one request's private stream: ``seed`` when the
    request pinned one, else a mix of the engine seed and the request id
    (numpy's SeedSequence, so neighbouring ids give unrelated streams)."""
    if seed is not None:
        return int(seed) & 0x7FFF_FFFF_FFFF_FFFF
    ss = np.random.SeedSequence([int(engine_seed) & 0xFFFF_FFFF,
                                 int(request_id) & 0xFFFF_FFFF])
    return int(ss.generate_state(1, np.uint64)[0]) & 0x7FFF_FFFF_FFFF_FFFF


def request_generator(engine_seed: int, request_id: int,
                      seed: Optional[int] = None) -> torch.Generator:
    """The CPU generator one request samples from."""
    return generator(request_seed(engine_seed, request_id, seed))
