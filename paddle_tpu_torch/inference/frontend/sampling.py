"""Per-request sampling configuration for the serving front door.

The port's copy of ``paddle_tpu/inference/frontend/sampling.py``.

One immutable bundle of the knobs a caller may set per request. Every
knob is a RUNTIME argument of the engine's compiled programs (per-slot
vectors, like temperature and greedy): an arbitrary mix of
greedy, temperature, top-k and top-p requests decodes in ONE lockstep
batch through the same two executables — ``executable_count()`` stays
flat across any sampling mix, which is the whole trick (on the card:
the sentinel's argument signatures stay flat across the mix).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from paddle_tpu_torch.core.unported import refuse_unported

__all__ = ["SamplingParams"]


@dataclass(frozen=True)
class SamplingParams:
    """Validated per-request sampling knobs.

    Parameters
    ----------
    temperature : float
        Softmax temperature (> 0). Ignored for greedy requests.
    top_k : int, optional
        Keep only the k highest-probability tokens (>= 1). ``None``
        disables.
    top_p : float, optional
        Nucleus sampling (Holtzman 2020): keep the smallest
        probability-sorted prefix whose mass reaches ``top_p``
        (0 < top_p <= 1; boundary ties stay in). ``None`` disables.
        Composes with ``top_k`` — the effective kept set is the
        intersection.
    greedy : bool
        Argmax decoding; filters don't change the argmax token, so a
        greedy request's output is independent of top_k/top_p.
    seed : int, optional
        Pins the request's private sample stream (position-keyed, so
        the stream is independent of co-running neighbours). Unset, it
        derives from the engine seed and the request id.
    response_format : optional
        Constrained decoding in the reference; the port has no
        grammar compiler yet, so it is accepted at None only.
    """

    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    greedy: bool = False
    seed: Optional[int] = None
    response_format: Optional[object] = None

    def __post_init__(self):
        if self.temperature <= 0.0:
            raise ValueError(
                f"temperature must be > 0, got {self.temperature} "
                "(use greedy=True for deterministic decoding)")
        if self.top_k is not None and int(self.top_k) < 1:
            raise ValueError(f"top_k must be >= 1, got {self.top_k}")
        if self.top_p is not None and not 0.0 < float(self.top_p) <= 1.0:
            raise ValueError(
                f"top_p must be in (0, 1], got {self.top_p}")
        refuse_unported("SamplingParams",
                        response_format=(self.response_format, None))
