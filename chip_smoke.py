#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
NVIDIA Hopper card (compute capability 9.0), the CUDA toolkit's ``nvcc``
and PyTorch built for CUDA; it imports nothing of JAX or ``paddle_tpu``.
Phases, in order (any failure exits non-zero and prints no result):

1. card: the ``nvidia-smi`` name and power limit, the capability;
2. build: ``csrc/*.cu`` -> ``build/kernels/`` with ``nvcc`` for sm_90a;
3. kernels: K2 LayerNorm, K4 paged decode and K5 chunk prefill, each
   against its plain PyTorch version in fp32 and bf16 at the serving
   path's shapes, on pools poisoned where no query may read (1e9 in
   unreadable rows of mapped blocks, NaN in blocks no table names; for
   the kernel alone also NaN in every unreadable row), with
   device times beside the plain version, one library call and the
   card's lower bound;
4. serving: ``gpt2_small`` at full width and depth (random weights from a
   seed) serves 16 requests through ``ServingEngine`` on the card; the
   kernels' launch counters must equal what the engine's own chunk and
   step counts imply, and every greedy token must equal the argmax of a
   teacher-forced no-cache forward (near-ties counted, not failed);
5. the ``kernels`` JSON line, then the ``ok`` line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, dense, at a 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12,      # fp32 on the CUDA cores
              "bfloat16": 989e12}    # bf16 on the tensor cores

# fp32: the kernels and the plain versions differ only in summation
# order (online softmax over blocks vs one softmax; warp-shuffle vs
# torch's reduction tree). bf16: the output is rounded to bf16 once, up
# to half an ulp (0.0156 below |y| = 8); the reference is the plain
# version evaluated in fp32 on the same bf16 values, because the bf16
# plain version itself rounds logits and P to bf16 at other places.
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


# ---------------------------------------------------------------- timing
class Timer:
    """Median device time of single launches, from CUDA events recorded
    around each one. All launches of a measurement are enqueued behind a
    spin kernel, so the host's own overhead never shows as device time;
    a 64 MB write between launches evicts the 50 MB L2, so every launch
    finds its inputs cold, as one layer's pools are in a real step."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        self.cycles = 20_000_000

    def __call__(self, fn, n: int = 50) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        while True:
            ev = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(n)]
            torch.cuda._sleep(self.cycles)
            for start, end in ev:
                self.flush.zero_()
                start.record()
                fn()
                end.record()
            # the device had not reached the last launch when the host
            # finished enqueueing: it never waited for the host
            ahead = not ev[-1][0].query()
            torch.cuda.synchronize()
            if ahead:
                return float(np.median([s.elapsed_time(e) for s, e in ev]))
            self.cycles *= 4
            check(self.cycles < 8_000_000_000,
                  "could not enqueue 50 launches ahead of the device")


# --------------------------------------------------------------- phases
def card_phase(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    cap = torch.cuda.get_device_capability(0)
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} | capability {cap}", flush=True)
    check(cap == (9, 0), f"compute capability {cap}: the kernels are "
          "built for sm_90a (Hopper)")
    return card


def build_phase():
    from paddle_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.load_library()
    secs = time.perf_counter() - t0
    how = "compiled" if _build.build_seconds is not None else "cached"
    print(f"build: {secs:.2f} s ({how}) from "
          f"{', '.join(p.name for p in _build.sources())} into "
          f"{_build.build_dir()}", flush=True)


def _bound(nbytes: float, flops: float, dtype: str):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / PEAK_FLOPS[dtype] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _err(out, ref) -> float:
    return float((out.float() - ref.float()).abs().max())


def _record(rows, name, dtype, shape, err, timer, kernel, plain, library,
            nbytes, flops):
    bound_ms, bound_by = _bound(nbytes, flops, dtype)
    row = {"kernel": name, "dtype": dtype, "shape": shape,
           "max_abs_err": err, "kernel_ms": timer(kernel),
           "plain_ms": timer(plain),
           "library_ms": timer(library), "bound_ms": bound_ms,
           "bound_by": bound_by}
    rows.append(row)
    print("  " + json.dumps(row), flush=True)


def layer_norm_phase(torch, timer, rows):
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.kernels import layer_norm as k2

    g = torch.Generator(device="cuda").manual_seed(11)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for R, C in ((8, 768), (128, 768)):
            x32 = torch.randn(R, C, device="cuda", generator=g) * 2 + 0.5
            w32 = 1 + 0.1 * torch.randn(C, device="cuda", generator=g)
            b32 = 0.1 * torch.randn(C, device="cuda", generator=g)
            x, w, b = x32.to(dtype), w32.to(dtype), b32.to(dtype)
            y, mean, rstd = k2.layer_norm_fwd(x, w, b, 1e-5)
            ry, rmean, rrstd = k2.layer_norm_ref(x.float(), w.float(),
                                                 b.float(), 1e-5)
            torch.cuda.synchronize()
            err = _err(y, ry)
            check(err <= ATOL[dn], f"K2 {dn} ({R},{C}): max |y - plain| "
                  f"{err} > {ATOL[dn]}")
            check(_err(mean, rmean) <= 2e-5 and _err(rstd, rrstd) <= 2e-5,
                  f"K2 {dn} ({R},{C}): mean/rstd disagree with the plain "
                  "version")
            for wi, bi in ((w, None), (None, b), (None, None)):
                yo = k2.layer_norm_fwd(x, wi, bi, 1e-5)[0]
                ro = k2.layer_norm_ref(
                    x.float(), None if wi is None else wi.float(),
                    None if bi is None else bi.float(), 1e-5)[0]
                check(_err(yo, ro) <= ATOL[dn],
                      f"K2 {dn} ({R},{C}) optional-affine case disagrees")
            sz = x.element_size()
            _record(rows, "K2", dn, [R, C], err, timer,
                    lambda: k2.layer_norm_fwd(x, w, b, 1e-5),
                    lambda: k2.layer_norm_ref(x, w, b, 1e-5),
                    lambda: TF.layer_norm(x, (C,), w, b, 1e-5),
                    nbytes=R * C * 2 * sz + 2 * C * sz + 8 * R,
                    flops=8 * R * C)


def _pool_case(torch, rs, nslots, bp, bs, H, D, dtype, spare=16):
    """Random pools and a table of distinct blocks (block 0, the scratch
    sink, and ``spare`` blocks are named by no table row)."""
    nblk = 1 + nslots * bp + spare
    table = (1 + rs.permutation(nblk - 1)[:nslots * bp]).reshape(
        nslots, bp).astype(np.int32)
    kp = torch.from_numpy(rs.randn(nblk, bs, H, D).astype(np.float32))
    vp = torch.from_numpy(rs.randn(nblk, bs, H, D).astype(np.float32))
    return (kp.to("cuda", dtype), vp.to("cuda", dtype),
            torch.from_numpy(table).cuda(), table)


def _poison(torch, kp, vp, table, reach, dead=1e9):
    """``dead`` in every pool row no (slot, table entry) can read under
    the mask ``col <= reach[slot]``; NaN in every block no table row
    names. For the plain version ``dead`` is 1e9, not NaN: it gathers
    whole table rows and multiplies their masked rows by p = 0."""
    nblk, bs = kp.shape[0], kp.shape[1]
    readable = np.zeros((nblk, bs), bool)
    named = np.zeros((nblk,), bool)
    cols = np.arange(table.shape[1] * bs)
    for o in range(table.shape[0]):
        named[table[o]] = True
        ok = cols <= reach[o]
        readable[table[o][cols[ok] // bs], cols[ok] % bs] = True
    kp, vp = kp.clone(), vp.clone()
    rows_dead = torch.from_numpy(~readable).cuda()
    unnamed = torch.from_numpy(~named).cuda()
    for p in (kp, vp):
        p[rows_dead] = dead
        p[unnamed] = float("nan")
    return kp, vp


def _dense_view(torch, kp, vp, table_t, nrows):
    """Gathered (b, H, nrows, D) K and V for the library yardstick."""
    bs = kp.shape[1]
    nb = (nrows + bs - 1) // bs
    idx = table_t[:, :nb].long()
    b = table_t.shape[0]
    k = kp[idx].reshape(b, nb * bs, *kp.shape[2:])[:, :nrows]
    v = vp[idx].reshape(b, nb * bs, *vp.shape[2:])[:, :nrows]
    return (k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous())


def _attention_case(torch, timer, rows, name, kernel_fn, ref_fn, q, kp, vp,
                    table_t, table, t, reach, dn, shape, nbytes, flops):
    import torch.nn.functional as TF

    out = kernel_fn(q, kp, vp, table_t, t)
    ref = ref_fn(q.float(), kp.float(), vp.float(), table_t, t)
    kpp, vpp = _poison(torch, kp, vp, table, reach)
    out_p = kernel_fn(q, kpp, vpp, table_t, t)
    ref_p = ref_fn(q.float(), kpp.float(), vpp.float(), table_t, t)
    # the kernel alone: NaN in EVERY unreadable row, so one stray read
    # of any row past a CTA's reach would turn the output NaN
    kpn, vpn = _poison(torch, kp, vp, table, reach, dead=float("nan"))
    out_n = kernel_fn(q, kpn, vpn, table_t, t)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out_p).all() and torch.isfinite(out_n).all()),
          f"{name} {dn} {shape}: non-finite output on a poisoned pool")
    err = max(_err(out, ref), _err(out_p, ref_p), _err(out_p, out),
              _err(out_n, out))
    check(err <= ATOL[dn], f"{name} {dn} {shape}: max |kernel - plain| "
          f"{err} > {ATOL[dn]} (clean, poisoned, or poisoned vs clean)")
    # library yardstick: SDPA over the pre-gathered dense view (gather
    # not timed), masked col <= t + i
    b, s = q.shape[0], q.shape[1]
    nrows = min(int(max(reach)) + 1, table.shape[1] * kp.shape[1])
    kd, vd = _dense_view(torch, kp, vp, table_t, nrows)
    qd = q.transpose(1, 2).contiguous()
    tt = torch.as_tensor(t, device="cuda").reshape(-1, 1, 1, 1)
    mask = (torch.arange(nrows, device="cuda")[None, None, None, :]
            <= tt + torch.arange(s, device="cuda")[None, None, :, None])
    _record(rows, name, dn, shape, err, timer,
            lambda: kernel_fn(q, kp, vp, table_t, t),
            lambda: ref_fn(q, kp, vp, table_t, t),
            lambda: TF.scaled_dot_product_attention(qd, kd, vd,
                                                    attn_mask=mask),
            nbytes=nbytes, flops=flops)


def paged_phase(torch, timer, rows):
    from paddle_tpu_torch.ops.kernels import paged_attention as k4

    b, s, H, D, bs, bp = 8, 1, 12, 64, 16, 64
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        rs = np.random.RandomState(21)
        kp, vp, table_t, table = _pool_case(torch, rs, b, bp, bs, H, D,
                                            dtype)
        t_np = np.linspace(0, 1000, b).round().astype(np.int32)
        rs.shuffle(t_np)
        t = torch.from_numpy(t_np).cuda()
        q = torch.from_numpy(rs.randn(b, s, H, D).astype(np.float32)).to(
            "cuda", dtype)
        sz = q.element_size()
        nbytes = (int((t_np + s).sum()) * H * D * 2 * sz
                  + 2 * b * s * H * D * sz + table.nbytes + 4 * b)
        flops = 4 * s * int((t_np + s).sum()) * H * D
        _attention_case(torch, timer, rows, "K4", k4.paged_attention,
                        k4.paged_attention_ref, q, kp, vp, table_t, table,
                        t, t_np + s - 1, dn, [b, s, H, D, bs, bp], nbytes,
                        flops)


def chunk_phase(torch, timer, rows):
    from paddle_tpu_torch.ops.kernels import chunk_prefill as k5

    H, D, bs, bp = 12, 64, 16, 64
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        # (64, 1000): a chunk whose pad tail runs past the table's end
        for s, start in ((128, 0), (128, 128), (128, 517), (100, 300),
                         (64, 1000)):
            rs = np.random.RandomState(31 + start + s)
            kp, vp, table_t, table = _pool_case(torch, rs, 1, bp, bs, H, D,
                                                dtype)
            q = torch.from_numpy(rs.randn(1, s, H, D).astype(
                np.float32)).to("cuda", dtype)
            t = torch.tensor(start, dtype=torch.int32, device="cuda")
            sz = q.element_size()
            keys = min(start + s, bp * bs)     # rows the table can hold
            nbytes = keys * H * D * 2 * sz + 2 * s * H * D * sz + table.nbytes
            flops = 4 * H * D * sum(min(start + i + 1, keys)
                                    for i in range(s))
            _attention_case(torch, timer, rows, "K5", k5.chunk_prefill,
                            k5.chunk_prefill_ref, q, kp, vp, table_t, table,
                            t, [start + s - 1], dn,
                            [s, start, H, D, bs, bp], nbytes, flops)


def serving_phase(torch, card):
    from paddle_tpu_torch.inference import Request, ServingEngine
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_small
    from paddle_tpu_torch.ops.kernels import chunk_prefill as k5
    from paddle_tpu_torch.ops.kernels import layer_norm as k2
    from paddle_tpu_torch.ops.kernels import paged_attention as k4

    # fp32 end to end, and no TF32 in any product: the greedy check
    # below compares two fp32 computations of the same logits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt2_small()
    # GPT's initialisers from a seeded generator: normal(0, 0.02), the
    # residual output projections scaled by 1/sqrt(2 * layers)
    model = GPTForCausalLM(cfg, device="cuda", seed=0)
    model.eval()
    eng = ServingEngine(model, max_batch_slots=8, max_len=1024,
                        block_size=16, prefill_chunk=128, seed=0,
                        device="cuda")
    # warm-up (cuBLAS handles, allocator), outside the counted run
    eng.submit(Request(prompt=[1, 2, 3], max_new_tokens=4, greedy=True))
    eng.run()

    rs = np.random.RandomState(0)
    reqs, streamed = [], {}
    sampled = set(rs.choice(16, 4, replace=False).tolist())
    for i in range(16):
        plen = int(rs.randint(24, 701))
        n = int(rs.randint(32, 65))
        prompt = rs.randint(0, cfg.vocab_size, plen).tolist()
        kw = (dict(temperature=0.8, top_p=0.9) if i in sampled
              else dict(greedy=True))
        reqs.append(Request(
            prompt=prompt, max_new_tokens=n,
            on_token=lambda r, tok, done: streamed.setdefault(
                r.id, []).append((tok, bool(done))), **kw))
    for r in reqs:
        eng.submit(r)

    for m in (k2, k4, k5):
        m.reset_launches()
    t0 = time.perf_counter()
    agg = eng.run().aggregate()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K2": k2.launches, "K4": k4.launches, "K5": k5.launches}

    chunks, steps = int(agg["prefill_chunks"]), int(agg["decode_steps"])
    L = cfg.num_layers
    print(f"serving: {int(agg['completed'])} requests, {chunks} prefill "
          f"chunks, {steps} decode steps, {int(agg['preemptions'])} "
          f"preemptions, blocks peak {int(agg['blocks_in_use_peak'])}, "
          f"launches {launches}", flush=True)
    for r in reqs:
        check(r.status == "done" and r.finish_reason in ("length", "eos"),
              f"request {r.id} ended {r.status}/{r.finish_reason}")
        check([tk for tk, _ in streamed[r.id]] == r.tokens
              and streamed[r.id][-1][1],
              f"request {r.id}: the stream differs from its tokens")
    want = {"K2": (2 * L + 1) * (chunks + steps), "K4": L * steps,
            "K5": L * chunks}
    check(launches == want, f"launch counts {launches} != {want} implied "
          f"by {chunks} chunks and {steps} steps")

    # greedy consistency: a teacher-forced no-cache forward of prompt +
    # tokens[:-1] must put its argmax on every emitted token, except at a
    # near-tie (top-2 gap < 1e-3). The no-cache forward is off the
    # serving path: until the flash kernel K1 is ported its attention is
    # the plain _sdpa math on every device.
    near_ties = checked = 0
    with torch.inference_mode():
        for r in reqs:
            if not r.greedy:
                continue
            ids = torch.tensor([list(r.prompt) + r.tokens[:-1]],
                               device="cuda")
            logits = model(ids)[0, len(r.prompt) - 1:].float()
            top2 = torch.topk(logits, 2, dim=-1).values
            arg = logits.argmax(dim=-1).cpu().numpy()
            gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
            for pos, (a, tok, g) in enumerate(zip(arg, r.tokens, gap)):
                checked += 1
                if a != tok:
                    check(g < 1e-3, f"request {r.id} position {pos}: "
                          f"emitted {tok}, no-cache argmax {a}, top-2 gap "
                          f"{g}")
                    near_ties += 1
    print(f"greedy consistency: {checked} tokens checked, {near_ties} "
          "near-tie mismatches (top-2 gap < 1e-3)", flush=True)
    print(f"serving perf on {card}: {agg['aggregate_tokens_per_s']:.1f} "
          f"tokens/s, TTFT p50 {agg['ttft_p50_s'] * 1e3:.1f} ms, decode "
          f"step p50 {agg['decode_step_ms_p50']:.2f} ms, wall {wall:.2f} s",
          flush=True)
    return launches


KERNELS = {
    "K2": ("layer_norm", "paddle_tpu_torch/csrc/layer_norm.cu",
           "paddle_tpu/ops/pallas/layer_norm.py:31"),
    "K4": ("paged_attention", "paddle_tpu_torch/csrc/paged_attention.cu",
           "paddle_tpu/ops/pallas/paged_attention.py:103"),
    "K5": ("chunk_prefill", "paddle_tpu_torch/csrc/chunk_prefill.cu",
           "paddle_tpu/ops/pallas/chunk_prefill.py:93"),
}
# the row each kernel reports in the kernels line: fp32 (the serving
# phase's dtype) at the decode shape for K2 and K4, and the deepest
# prefix for K5
HEADLINE = {"K2": [8, 768], "K4": [8, 1, 12, 64, 16, 64],
            "K5": [128, 517, 12, 64, 16, 64]}


def main():
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs the "
             "port on an NVIDIA card")
    card = card_phase(torch)
    build_phase()
    timer = Timer(torch)
    rows = []
    print("kernels vs plain versions (device ms, cold L2):", flush=True)
    layer_norm_phase(torch, timer, rows)
    paged_phase(torch, timer, rows)
    chunk_phase(torch, timer, rows)
    launches = serving_phase(torch, card)

    out = []
    for kid, (name, src, replaces) in KERNELS.items():
        row = next(r for r in rows if r["kernel"] == kid
                   and r["dtype"] == "float32"
                   and r["shape"] == HEADLINE[kid])
        check(launches[kid] > 0, f"{kid} was never launched on the path")
        out.append({"name": f"{kid} {name}", "route": "cuda",
                    "source": src, "replaces": replaces,
                    "launches": launches[kid],
                    "max_abs_err": row["max_abs_err"],
                    "ms": row["kernel_ms"],
                    "plain_ms": row["plain_ms"],
                    "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"],
                    "library_ms": row["library_ms"]})
    print(f"total {time.perf_counter() - t_start:.1f} s on {card}",
          flush=True)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
