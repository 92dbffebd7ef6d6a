#!/usr/bin/env python3
"""One rank of ``chip_smoke.py``'s phase 8e: ``gpt2_small`` trained over
a mesh of ranks on one card, through ``ShardedTrainer(mesh=)``.

Started by the port's launcher, one process a rank, all on the same
card over the gloo backend (NCCL refuses two ranks of one communicator
on one device)::

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node N \\
        mesh_gang.py OUT CASE [CASE ...]

``OUT`` holds ``ref.pt`` (the one-process run's losses and parameters,
written by ``chip_smoke.py``) and receives ``<case>.rank<r>.json``. Each
``CASE`` (``MESHES``) trains ``gpt2_small`` at full width and depth
(weights from seed 0, dropout off), global batch 8 x 1024, AdamW (lr
1e-4, weight decay 0.01) with a global-norm clip of 1.0:

- 3 steps in fp32 with TF32 off; the losses and this rank's window of
  every parameter held against ``ref.pt`` (the distances all-reduced,
  max, over the gang) and this rank's K1, K3a and K2 launches counted;
  case ``e`` also saves its checkpoint (``OUT/ckpt_e``) and records its
  4th loss;
- under bf16 AMP: one warm-up step, then ``TIMED`` steps on the host
  clock (each ends in ``torch.cuda.synchronize()``), their launches
  counted too. Gloo moves every collective through the host, so these
  are not a measure of NCCL.

It imports nothing of JAX or ``paddle_tpu``.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time

import numpy as np

AXES = ["dp", "pp", "sharding", "mp"]
# case: (mesh [dp, pp, sharding, mp], ZeRO stage)
MESHES = {"b": ([2, 1, 1, 1], 0), "c": ([1, 1, 1, 2], 0),
          "d2": ([1, 1, 2, 1], 2), "d3": ([1, 1, 2, 1], 3),
          "e": ([2, 1, 1, 2], 0)}
BATCH, SEQ, STEPS, TIMED = 8, 1024, 3, 2
LR, CLIP = 1e-4, 1.0


def batch_ids(vocab: int) -> np.ndarray:
    """The global batch every run of phase 8e trains on."""
    return np.random.RandomState(0).randint(0, vocab, (BATCH, SEQ))


def make_trainer(torch, cfg, mesh=None, stage=0, amp=False, wrap=None):
    """``gpt2_small`` from seed 0 on this rank's card, AdamW with the
    clip, and its trainer (``wrap`` wraps the optimizer)."""
    from paddle_tpu_torch.distributed import (DistributedStrategy,
                                              ShardedTrainer)
    from paddle_tpu_torch.models import GPTForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    model = GPTForCausalLM(cfg, device=torch.device(
        "cuda", torch.cuda.current_device()), seed=0)
    model.train()
    opt = AdamW(learning_rate=LR, parameters=model.named_parameters(),
                weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(CLIP))
    if wrap is not None:
        opt = wrap(opt)
    st = DistributedStrategy()
    if stage:
        st.sharding = True
        st.sharding_configs = {"stage": stage}
    return ShardedTrainer(model, opt, None, mesh=mesh, strategy=st, amp=amp)


def counts(fa, k2):
    return {"K1": fa.launches["fwd"], "K3a": fa.launches["bwd_fused"],
            "K3b": fa.launches["bwd_dkv"] + fa.launches["bwd_dq"],
            "K2": k2.launches}


def _distance(torch, trainer, ref, mesh):
    """The largest |parameter - reference| over this rank's windows,
    max-reduced over the gang."""
    worst = 0.0
    for key, t, spec, shape in trainer._entries():
        if not key.startswith("param/"):
            continue
        win = mesh.window(spec, shape)
        want = ref["params"][key[len("param/"):]][
            tuple(slice(a, b) for a, b in win)].to(t.device)
        worst = max(worst, float((t.float() - want).abs().max()))
    d = torch.tensor([worst], dtype=torch.float64)
    torch.distributed.all_reduce(d, op=torch.distributed.ReduceOp.MAX)
    return float(d)


def run_case(torch, name, out, ref, ids, cfg):
    from paddle_tpu_torch.distributed import build_mesh
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import layer_norm as k2

    dims, stage = MESHES[name]
    mesh = build_mesh(dims, AXES)
    res = {"mesh": dims, "stage": stage}
    trainer = make_trainer(torch, cfg, mesh, stage)
    torch.cuda.synchronize()
    fa.reset_launches()
    k2.reset_launches()
    losses = [float(trainer.train_step(ids, ids)) for _ in range(STEPS)]
    torch.cuda.synchronize()
    res["fp32_launches"] = counts(fa, k2)
    res["losses"] = losses
    res["loss_rel"] = max(abs(a - b) / abs(b)
                          for a, b in zip(losses, ref["losses"]))
    res["param_abs"] = _distance(torch, trainer, ref, mesh)
    if name == "e":
        trainer.save_checkpoint(os.path.join(out, "ckpt_e"))
        res["next_loss"] = float(trainer.train_step(ids, ids))
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    trainer = make_trainer(torch, cfg, mesh, stage, amp=True)
    trainer.train_step(ids, ids)
    torch.cuda.synchronize()
    fa.reset_launches()
    k2.reset_launches()
    step_ms = []
    for _ in range(TIMED):
        t0 = time.perf_counter()
        loss = trainer.train_step(ids, ids)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    res["bf16_launches"] = counts(fa, k2)
    res["bf16_step_ms"] = step_ms
    res["bf16_loss"] = float(loss)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return res


def main():
    out, cases = sys.argv[1], sys.argv[2:]
    import torch

    from paddle_tpu_torch.distributed import init_parallel_env
    from paddle_tpu_torch.models import gpt2_small

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = init_parallel_env(backend="gloo", timeout=300)
    torch.cuda.set_device(env.device_id)
    cfg = gpt2_small()
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    ref = torch.load(os.path.join(out, "ref.pt"), map_location="cpu")
    ids = torch.from_numpy(batch_ids(cfg.vocab_size))
    for name in cases:
        res = run_case(torch, name, out, ref, ids, cfg)
        with open(os.path.join(out, f"{name}.rank{env.rank}.json"),
                  "w") as f:
            json.dump(res, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
