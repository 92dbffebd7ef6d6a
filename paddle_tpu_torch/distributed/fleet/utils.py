"""fleet.utils — activation recompute, the port of
``paddle_tpu/distributed/fleet/utils.py``.

``recompute(function, *args)`` runs ``function`` so that the backward
rematerializes its activations instead of keeping them: the forward runs
under ``torch.utils.checkpoint(use_reentrant=False,
preserve_rng_state=True)``, which saves only the segment's inputs and
replays the segment when its gradient is needed. The replay reproduces
the forward exactly:

- the random draws (hidden and attention dropout) come from the CPU and
  device generators, whose states the checkpoint saves and restores, so
  the replay draws the same masks;
- the AMP state (``amp.auto_cast``) in force at the forward is put back
  around the replay, which runs during the backward, after the user's
  ``auto_cast`` block has closed, so it casts as the forward cast;
- so is the sequence-parallel schedule (``sequence_parallel_mode``): a
  forward run under Ulysses replays under Ulysses, and saves tensors of
  the shapes the forward saved.

The reference lowers the segment through ``jax.checkpoint`` in a traced
step and is the identity on its eager tape; the port always runs
eagerly, so it always rematerializes when a gradient is being recorded,
and is a plain call when none is (``torch.no_grad()``).
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch.amp.auto_cast import amp_state, auto_cast

__all__ = ["recompute"]


def _amp_replay():
    """``checkpoint``'s context_fn: nothing around the forward, and the
    forward's AMP state and sequence-parallel schedule around the
    replay."""
    from paddle_tpu_torch.distributed import ulysses
    st = amp_state()
    amp = auto_cast(enable=st.enabled, custom_white_list=st.custom_white,
                    custom_black_list=st.custom_black, level=st.level,
                    dtype=st.dtype)     # reads the state now, not at replay
    mode = ulysses.get_sequence_parallel_mode()

    @contextlib.contextmanager
    def replay():
        with amp, ulysses.sequence_parallel_mode(mode):
            yield

    return contextlib.nullcontext(), replay()


def recompute(function, *args, **kwargs):
    """Run ``function(*args, **kwargs)`` so that its activations are
    rematerialized in the backward (reference fleet.utils.recompute).
    ``preserve_rng_state`` is recompute's own keyword, not the
    function's: it is taken off, and the RNG state is always preserved
    (the replay must draw the dropout masks the forward drew)."""
    kwargs.pop("preserve_rng_state", None)
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=True, context_fn=_amp_replay,
                      **kwargs)
