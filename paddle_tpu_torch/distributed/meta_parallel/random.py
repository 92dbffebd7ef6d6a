"""Tensor-parallel RNG streams — the port of
``paddle_tpu/distributed/meta_parallel/random.py``.

The tracker keeps named streams, each a ``torch.Generator`` per device
type, seeded by ``add(name, seed)``. ``rng_state(name)`` swaps the
stream in as torch's default generator of the CPU and of the current
card for the duration (dropout draws from those), and keeps what it
drew: a later ``rng_state(name)`` continues the stream, while the
default generators continue where they were.

``model_parallel_random_seed(seed)`` seeds the two kinds of region of a
tensor-parallel model: the replicated region draws from the global
generators, seeded ``seed + 100003`` alike on every rank; the
model-parallel stream ``model_parallel_rng`` is seeded ``seed + 1024 +
mp_rank``, so each rank of the ``mp`` axis draws its own masks for its
own shard.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

__all__ = ["RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed"]

MODEL_PARALLEL_RNG = "model_parallel_rng"


def _cuda_on() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


class RNGStatesTracker:
    def __init__(self):
        self.states_: Dict[str, Dict[str, torch.Generator]] = {}
        self.seeds_ = set()

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def add(self, name: str, seed: int):
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already exists")
        if name in self.states_:
            raise ValueError(f"state {name} already exists")
        self.seeds_.add(seed)
        gens = {"cpu": torch.Generator().manual_seed(int(seed))}
        if _cuda_on():
            gens["cuda"] = torch.Generator(
                device=torch.device("cuda", torch.cuda.current_device())
            ).manual_seed(int(seed))
        self.states_[name] = gens

    def get_states_tracker(self):
        return {k: {d: g.get_state() for d, g in v.items()}
                for k, v in self.states_.items()}

    def set_states_tracker(self, states):
        for k, v in states.items():
            for d, s in v.items():
                self.states_[k][d].set_state(s)

    @contextlib.contextmanager
    def rng_state(self, name: str = MODEL_PARALLEL_RNG):
        if name not in self.states_:
            raise ValueError(f"state {name} does not exist")
        gens = self.states_[name]
        saved_cpu = torch.get_rng_state()
        torch.set_rng_state(gens["cpu"].get_state())
        cuda = "cuda" in gens and _cuda_on()
        if cuda:
            saved_cuda = torch.cuda.get_rng_state()
            torch.cuda.set_rng_state(gens["cuda"].get_state())
        try:
            yield
        finally:
            gens["cpu"].set_state(torch.get_rng_state())
            torch.set_rng_state(saved_cpu)
            if cuda:
                gens["cuda"].set_state(torch.cuda.get_rng_state())
                torch.cuda.set_rng_state(saved_cuda)


_TRACKER = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _TRACKER


def model_parallel_random_seed(seed: int = 0):
    """Seed the replicated region (alike on every rank) and the
    model-parallel stream (one per ``mp`` rank)."""
    from paddle_tpu_torch.core import random as rng
    from paddle_tpu_torch.distributed import fleet

    hcg = fleet.get_hybrid_communicate_group()
    mp_rank = hcg.get_model_parallel_rank() if hcg is not None else 0
    _TRACKER.reset()
    rng.seed(seed + 100003)
    _TRACKER.add(MODEL_PARALLEL_RNG, seed + 1024 + mp_rank)
