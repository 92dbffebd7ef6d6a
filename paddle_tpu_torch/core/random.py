"""Seeded random numbers for the PyTorch port.

Counterpart of ``paddle_tpu/core/random.py``. JAX threads one functional
key through the program; the port has two sources instead:

- one ``torch.Generator`` per engine or per model build
  (:func:`generator`), seeded by the caller;
- for serving, a COUNTER-BASED stream: every request owns ``(2,)``
  uint32 key data (:func:`request_keydata`, from ``Request.seed`` when
  set, else from the engine seed and the request id), and the uniform
  that decides the token landing at position ``P`` of the request is
  :func:`position_uniforms` of ``(keydata, P, lane)`` — the port's
  counterpart of the reference's ``fold_in(slot_key, P)``
  (``inference/serving.py:838-868``). A draw is a pure function of the
  request and the position, so it never depends on the neighbouring
  slots, a rejected speculative draft never shifts the stream, and a
  preempted request replays the same draws.

The two frameworks give different numbers from the same seed (JAX's
threefry is not reproduced): parity tests hold sampling to its
distribution, and greedy decoding (which draws nothing) to exact tokens.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

__all__ = ["seed", "generator", "request_seed", "request_keydata",
           "position_uniforms", "LANE_DRAW", "LANE_COIN"]

# the lanes of one position: the token draw (plain decode, the prefill's
# first token, a verify's residual or bonus draw), and a speculative
# verify's acceptance coin
LANE_DRAW = 0
LANE_COIN = 1

_MASK32 = 0xFFFF_FFFF
# odd multipliers below 2**31: a 32-bit value times one stays below
# 2**63, so every product is exact in int64 on the CPU and on the card
_MUL1 = 0x7FEB352D
_MUL2 = 0x5BD1E995
_GOLDEN = 0x9E3779B9


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


def request_keydata(engine_seed: int, request_id: int,
                    seed: Optional[int] = None) -> np.ndarray:
    """One request's ``(2,)`` uint32 key data: the low and high words of
    :func:`request_seed`."""
    s = request_seed(engine_seed, request_id, seed)
    return np.asarray([s & _MASK32, s >> 32], np.uint32)


def _mix32(x):
    """A 32-bit avalanche (xorshift-multiply) of a Python int or an int64
    tensor holding values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = (x * _MUL1) & _MASK32
    x = x ^ (x >> 15)
    x = (x * _MUL2) & _MASK32
    return x ^ (x >> 16)


def position_uniforms(keydata, positions, lane: int) -> torch.Tensor:
    """float32 uniforms in [0, 1) of positions' shape: a counter-based
    hash of ``(keydata[slot], P, lane)``.

    ``keydata`` is ``(b, 2)`` uint32 key data (a tensor holding the
    values in any integer dtype, or a numpy array); ``positions`` is
    ``(b,)`` or ``(b, n)`` positions of slot ``b``'s stream; ``lane`` a
    small int (:data:`LANE_DRAW`, :data:`LANE_COIN`). The result lives
    on ``positions``' device. Every step is an exact int64 operation
    whose intermediates stay below 2**63, so the CPU and a CUDA device
    give the same bits."""
    pos = torch.as_tensor(positions).long()
    if isinstance(keydata, np.ndarray):
        keydata = torch.from_numpy(keydata.astype(np.int64))
    kd = keydata.to(pos.device).long() & _MASK32
    lead = (-1,) + (1,) * (pos.dim() - 1)
    k0, k1 = kd[..., 0].reshape(lead), kd[..., 1].reshape(lead)
    h = _mix32(k0 ^ _mix32((int(lane) * _GOLDEN + 1) & _MASK32))
    h = _mix32(h ^ k1)
    h = _mix32(h ^ (pos & _MASK32))
    h = _mix32((h + _GOLDEN) & _MASK32)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
