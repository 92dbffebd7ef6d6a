#!/usr/bin/env python3
"""One rank of ``chip_smoke.py``'s phase 8f: the pipeline and the
sequence axis over ranks on one card.

Started by the port's launcher, one process a rank, all on the same card
over the gloo backend (NCCL refuses two ranks of one communicator on one
device)::

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node N \\
        pipe_gang.py OUT CASE [CASE ...]

``OUT`` holds ``ref.pt`` (``gpt2_small``'s one-process run: losses, the
clip's global norms and the parameters after ``STEPS`` fp32 steps,
written by ``chip_smoke.py``) and
``bert_ref.pt`` (bert-base's one-process Pipe run), and receives
``<case>.rank<r>.json``. The GPT cases train ``gpt2_small`` at full
width and depth (weights from seed 0: ``GPTForCausalLMPipe`` and
``GPTForCausalLM`` draw the same values from one seed), dropout off,
the global batch 8 x 1024, ``STEPS`` fp32 steps (TF32 off) held to the
reference and counted, with SGD (lr 0.1, no weight decay) and a
global-norm clip of 1e4 that
never engages (the norms are recorded and held to the reference's), so
a gradient off by a factor (sep gradients averaged, a dp average
dropped, the extras not summed over pp) moves the parameters off the
reference: AdamW's step is blind to a gradient's scale. Then AdamW (lr
1e-4, weight decay 0.01) with a clip of 1.0: one bf16 AMP warm-up step
and ``TIMED`` timed steps (host clock, each ending in
``torch.cuda.synchronize()``; gloo moves every message through the
host, so these do not measure NCCL):

- ``b``: 1F1B pp 2, M 4 (6 blocks a stage); ``c``: pp 2, V 2, M 4
  (interleaved, 3 blocks a virtual stage); ``d``: dp 2 x pp 2 (4 ranks);
- ``e_ring`` / ``e_ulysses``: ``GPTForCausalLM`` on sep 2, the model's
  own fused loss; ``e_ulysses_rc`` the same under Ulysses with every
  block recomputed (``recompute_granularity="full"``): the replay runs
  on autograd's device thread and must take Ulysses as the forward did;
- ``f``: ``BertForPretrainingPipe`` at bert-base, 32 x 512, pp 2, M 4,
  ``BERT_STEPS`` fp32 steps against ``bert_ref.pt``;
- ``attn``: ``ring_self_attention`` and ``ulysses_self_attention`` at
  (2, 1024, 12, 64) bf16, causal, their outputs and q/k/v gradients
  against one rank's flash attention on the whole sequence;
- ``mem``: this rank's peak memory over one fp32 1F1B step at pp 2 with
  microbatches of 2 rows, M 4 (batch 8) and M 8 (batch 16).

It imports nothing of JAX or ``paddle_tpu``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import sys
import time

import numpy as np

from mesh_gang import _distance, counts
from paddle_tpu_torch.nn import ClipGradByGlobalNorm

AXES = ["dp", "pp", "sharding", "mp", "sep"]
# GPT case: (mesh, M, V) for the Pipe model, or (mesh, schedule) on sep
PIPES = {"b": ([1, 2, 1, 1, 1], 4, 1), "c": ([1, 2, 1, 1, 1], 4, 2),
         "d": ([2, 2, 1, 1, 1], 4, 1)}
SEPS = {"e_ring": "ring", "e_ulysses": "ulysses",
        "e_ulysses_rc": "ulysses"}
BATCH, SEQ, STEPS, TIMED = 8, 1024, 3, 2
BERT_BATCH, BERT_SEQ, BERT_STEPS = 32, 512, 2
LR, CLIP = 1e-4, 1.0
SGD_LR, SGD_CLIP = 0.1, 1e4
ATTN_SHAPE = (2, 1024, 12, 64)


def batch_ids(vocab: int, rows: int = BATCH, seq: int = SEQ) -> np.ndarray:
    return np.random.RandomState(0).randint(0, vocab, (rows, seq))


def bert_batch(vocab: int):
    """bert-base's MLM batch: ids, and labels at the same 15% of the
    positions in every row (-100 elsewhere), so every microbatch's mean
    counts as many labels and the mean over microbatches is the batch's
    mean, the one-process objective."""
    rs = np.random.RandomState(1)
    ids = rs.randint(0, vocab, (BERT_BATCH, BERT_SEQ))
    masked = np.zeros(BERT_SEQ, bool)
    masked[rs.choice(BERT_SEQ, int(0.15 * BERT_SEQ), replace=False)] = True
    return ids, np.where(masked, ids, -100)


def adamw(model):
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    return AdamW(learning_rate=LR, parameters=model.named_parameters(),
                 weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(CLIP))


def sgd(model):
    """The fp32 parity steps' optimizer: SGD with a clip that records
    each step's global norm and never engages."""
    from paddle_tpu_torch.optimizer import SGD

    return SGD(learning_rate=SGD_LR, parameters=model.named_parameters(),
               grad_clip=NormTap(SGD_CLIP))


def norms_of(opt):
    """The global gradient norms ``opt``'s clip saw, one a step."""
    return list(opt._grad_clip.norms)


class NormTap(ClipGradByGlobalNorm):
    """A global-norm clip that also records each global norm (over the
    bound mesh, as the clip computes it)."""

    def __init__(self, clip_norm):
        super().__init__(clip_norm)
        self.norms = []

    def __call__(self, params_grads):
        sq = self._global_norm_sq(params_grads)
        if sq is not None:
            self.norms.append(float(sq.sqrt()))
        return super().__call__(params_grads)


def gpt_pipe(torch, cfg, S, M, V):
    from paddle_tpu_torch.models import GPTForCausalLMPipe

    model = GPTForCausalLMPipe(cfg, S, M, V, device=torch.device(
        "cuda", torch.cuda.current_device()), seed=0)
    model.train()
    return model


def bert_pipe(torch, S, M):
    from paddle_tpu_torch.models import BertConfig, BertForPretrainingPipe

    cfg = BertConfig(hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    model = BertForPretrainingPipe(cfg, S, M, device=torch.device(
        "cuda", torch.cuda.current_device()), seed=0)
    model.train()
    return model


def pipe_reference(ref_params, model):
    """``gpt2_small``'s one-process parameters (``GPTForCausalLM`` names)
    in ``model``'s Pipe layout: stacked slot j holds virtual stage
    ``_virtual_order[j]``'s blocks."""
    import torch

    starts = np.concatenate([[0], np.cumsum(model._stage_counts)])
    out = {"first.wte.weight": ref_params["gpt.wte.weight"],
           "first.wpe.weight": ref_params["gpt.wpe.weight"],
           "last.ln_f.weight": ref_params["gpt.ln_f.weight"],
           "last.ln_f.bias": ref_params["gpt.ln_f.bias"]}
    for n in model._stack_names:
        i, rest = n.split(".", 2)[1:]
        out["stage__" + n.replace(".", "__")] = torch.stack([
            ref_params[f"gpt.h.{int(starts[w]) + int(i)}.{rest}"]
            for w in model._virtual_order])
    return out


def _free(torch):
    gc.collect()
    torch.cuda.empty_cache()


def train_case(torch, name, ref, cfg, ids, bert_data):
    """One trainer case: fp32 steps held to the reference, then the
    bf16 AMP steps timed."""
    from paddle_tpu_torch.distributed import (ShardedTrainer, build_mesh,
                                              sequence_parallel_mode)
    from paddle_tpu_torch.models import GPTForCausalLM, GPTForCausalLMPipe
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import layer_norm as k2

    if name in PIPES:
        dims, M, V = PIPES[name]
        mode = "ring"
    elif name in SEPS:
        dims, M, V, mode = [1, 1, 1, 1, 2], 1, 1, SEPS[name]
    else:
        dims, M, V, mode = [1, 2, 1, 1, 1], 4, 1, "ring"
    mesh = build_mesh(dims, AXES)
    res = {"mesh": dims, "M": M, "V": V}

    def build(amp, opt):
        if name == "f":
            model = bert_pipe(torch, 2, M)
            return model, ShardedTrainer(model, opt(model), model.mlm_loss,
                                         mesh=mesh, amp=amp)
        if name in SEPS:
            c = cfg
            if name.endswith("_rc"):
                c = dataclasses.replace(cfg, recompute_granularity="full")
            model = GPTForCausalLM(c, device=torch.device(
                "cuda", torch.cuda.current_device()), seed=0)
            model.train()
            return model, ShardedTrainer(model, opt(model), None,
                                         mesh=mesh, amp=amp)
        model = gpt_pipe(torch, cfg, 2, M, V)
        return model, ShardedTrainer(model, opt(model),
                                     GPTForCausalLMPipe.loss, mesh=mesh,
                                     amp=amp)

    batch = bert_data if name == "f" else (ids, ids)
    steps = BERT_STEPS if name == "f" else STEPS
    model, trainer = build(False, sgd)
    if name == "f":
        want = {k: v for k, v in ref["bert"]["params"].items()}
        ref_losses = ref["bert"]["losses"]
    elif name in SEPS:
        want, ref_losses = ref["params"], ref["losses"]
    else:
        want, ref_losses = pipe_reference(ref["params"], model), \
            ref["losses"]
    res["stage_counts"] = getattr(model, "_stage_counts", None)
    torch.cuda.synchronize()
    fa.reset_launches()
    k2.reset_launches()
    with sequence_parallel_mode(mode):
        losses = [float(trainer.train_step(*batch)) for _ in range(steps)]
    torch.cuda.synchronize()
    res["fp32_launches"] = counts(fa, k2)
    res["losses"] = losses
    res["loss_rel"] = max(abs(a - b) / abs(b)
                          for a, b in zip(losses, ref_losses))
    res["norms"] = norms_of(trainer.optimizer)
    ref_norms = ref["bert"]["norms"] if name == "f" else ref["norms"]
    res["norm_rel"] = max(abs(a - b) / b
                          for a, b in zip(res["norms"], ref_norms))
    res["param_abs"] = _distance(torch, trainer, {"params": want}, mesh)
    del model, trainer
    _free(torch)

    model, trainer = build(True, adamw)
    with sequence_parallel_mode(mode):
        trainer.train_step(*batch)
        torch.cuda.synchronize()
        fa.reset_launches()
        k2.reset_launches()
        step_ms = []
        for _ in range(TIMED):
            t0 = time.perf_counter()
            loss = trainer.train_step(*batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    res["bf16_launches"] = counts(fa, k2)
    res["bf16_step_ms"] = step_ms
    res["bf16_loss"] = float(loss)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del model, trainer
    _free(torch)
    return res


def attention_case(torch):
    """Ring and Ulysses (sep 2) against one rank's flash attention on
    the whole sequence: max |difference| over max |reference| of the
    output and of each gradient."""
    from paddle_tpu_torch.distributed import (build_mesh,
                                              ring_self_attention,
                                              ulysses_self_attention)
    from paddle_tpu_torch.ops.kernels.flash_attention import FlashAttentionFn

    mesh = build_mesh([2], ["sep"])
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, cot = (torch.randn(ATTN_SHAPE, device="cuda", generator=gen,
                                dtype=torch.bfloat16) for _ in range(4))
    scale = 1.0 / ATTN_SHAPE[-1] ** 0.5

    def run(fn):
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = fn(*ts)
        o.backward(cot)
        return [o.detach()] + [t.grad for t in ts]

    ref = run(lambda a, b, c: FlashAttentionFn.apply(a, b, c, scale, True))
    out = {}
    for name, fn in (("ring", ring_self_attention),
                     ("ulysses", ulysses_self_attention)):
        got = run(lambda a, b, c: fn(a, b, c, mesh, is_causal=True))
        out[name] = [float((g.float() - r.float()).abs().max()
                           / r.float().abs().max())
                     for g, r in zip(got, ref)]
    return out


def memory_case(torch, cfg):
    """Peak memory of one fp32 pp 2 step, microbatches of 2 rows, at M 4
    (batch 8) and M 8 (batch 16)."""
    from paddle_tpu_torch.distributed import ShardedTrainer, build_mesh

    mesh = build_mesh([1, 2, 1, 1, 1], AXES)
    out = {}
    for M in (4, 8):
        _free(torch)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        model = gpt_pipe(torch, cfg, 2, M, 1)
        trainer = ShardedTrainer(model, adamw(model), None, mesh=mesh)
        ids = batch_ids(cfg.vocab_size, rows=2 * M)
        trainer.train_step(ids, ids)
        torch.cuda.synchronize()
        out[f"M{M}"] = (torch.cuda.max_memory_allocated() - base) / 2**30
        del model, trainer
    _free(torch)
    return out


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
    bert_data = None
    if "f" in cases:
        ref["bert"] = torch.load(os.path.join(out, "bert_ref.pt"),
                                 map_location="cpu")
        bert_data = tuple(torch.from_numpy(a) for a in bert_batch(30522))
    for name in cases:
        t0 = time.perf_counter()
        if name == "attn":
            res = attention_case(torch)
        elif name == "mem":
            res = memory_case(torch, cfg)
        else:
            res = train_case(torch, name, ref, cfg, ids, bert_data)
        res["wall_s"] = time.perf_counter() - t0
        with open(os.path.join(out, f"{name}.rank{env.rank}.json"),
                  "w") as f:
            json.dump(res, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
