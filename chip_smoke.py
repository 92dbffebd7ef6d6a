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
4. flash: K1 (forward), K3a (fused backward) and K3b (the streaming
   dK/dV and dQ passes) against their plain versions in fp32 and bf16
   at the training shape, non-causal, at head_dim 128, and on the
   long-context route (S 8320, through ``F.scaled_dot_product_attention``
   and ``.backward()``, whose launch counters must show the streaming
   pair and not the fused kernel), with the same timings;
5. serving: ``gpt2_small`` at full width and depth (random weights from a
   seed) serves 16 requests through ``ServingEngine`` on the card; the
   kernels' launch counters must equal what the engine's own chunk and
   step counts imply, and every greedy token must equal the argmax of a
   teacher-forced no-cache forward (near-ties counted, not failed);
6. training: ``gpt2_small`` at full width and depth, batch 16 x 1024,
   ``AdamW`` and ``ShardedTrainer(amp=True)`` (the configuration of
   ``bench.py``), 2 warm-up and 10 timed steps: a finite, falling loss,
   exact launch counts per step, and an fp32 forward on the card equal
   to the same forward on the CPU; tokens/s, step p50 and MFU;
7. the ``kernels`` JSON line, then the ``ok`` line.
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

# flash kernels, relative to max(1, max |plain|) of each output. fp32:
# summation order over up to 8320 keys or queries, and the fused dQ's
# fp32 atomics, whose order changes from run to run. bf16: one rounding
# of each output to bf16, plus P and dS, which both sides round to bf16
# at the same places but from logits that differ in the last fp32 bits.
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


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
        for R, C in ((8, 768), (128, 768), (16384, 768)):
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


# (B, S, H, D, causal): the training shape, non-causal, head_dim 128; the
# long-context route (S > 8192) runs through the public functional
FLASH_CASES = [(16, 1024, 12, 64, True), (2, 1024, 12, 64, False),
               (2, 1024, 6, 128, True)]
FLASH_LONG = (1, 8320, 2, 64, True)


def _rel_err(out, ref) -> float:
    return _err(out, ref) / max(1.0, float(ref.float().abs().max()))


def _flash_inputs(torch, B, S, H, D, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(B, S, H, D, device="cuda", generator=g).to(dtype)
            for _ in range(4)]      # q, k, v, dO


def _flash_rows(torch, timer, rows, dn, shape, q, k, v, do, scale, causal,
                errs):
    """Time K1, K3a and the K3b pair at one shape (inputs as given) and
    record one row each; ``errs`` maps kernel id to its checked error."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    B, S, H, D = q.shape
    sz = q.element_size()
    n = B * S * H * D * sz            # bytes of one (B, S, H, D) tensor
    vec = B * H * S * 4               # bytes of lse or delta
    flops = 4 * B * H * S * S * D / (2 if causal else 1)
    o, lse = fa.flash_fwd_ref(q, k, v, scale, causal)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    bwd = (q, k, v, do, lse, delta, scale, causal)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    ql, kl, vl = (x.detach().clone().requires_grad_() for x in (qt, kt, vt))

    def library_fwd_bwd():
        out = TF.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
        torch.autograd.grad(out, (ql, kl, vl), dot)

    plain_bwd = timer(lambda: fa.flash_bwd_ref(*bwd), n=10)
    library_bwd = timer(library_fwd_bwd, n=10)
    for kid, fn, plain, library, nbytes, kflops in (
            ("K1", lambda: fa.flash_fwd(q, k, v, scale, causal),
             timer(lambda: fa.flash_fwd_ref(q, k, v, scale, causal), n=10),
             timer(lambda: TF.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=causal), n=10),
             4 * n + vec, flops),
            ("K3a", lambda: fa.flash_bwd_fused(*bwd), plain_bwd, library_bwd,
             7 * n + 2 * vec, 2.5 * flops),
            ("K3b-dkv", lambda: fa.flash_bwd_dkv(*bwd), plain_bwd,
             library_bwd, 6 * n + 2 * vec, 2.0 * flops),
            ("K3b-dq", lambda: fa.flash_bwd_dq(*bwd), plain_bwd, library_bwd,
             5 * n + 2 * vec, 1.5 * flops)):
        bound_ms, bound_by = _bound(nbytes, kflops, dn)
        row = {"kernel": kid, "dtype": dn, "shape": shape,
               "max_abs_err": errs[kid][0], "rel_err": errs[kid][1],
               "tol": FLASH_TOL[dn], "kernel_ms": timer(fn, n=10),
               "plain_ms": plain, "library_ms": library,
               "bound_ms": bound_ms, "bound_by": bound_by}
        rows.append(row)
        print("  " + json.dumps(row), flush=True)


def _flash_check(torch, dn, shape, pairs):
    """Worst (max |err|, relative err) over ``pairs`` (name -> (kernel,
    plain)); fails on a non-finite value or an error past FLASH_TOL."""
    worst = (0.0, 0.0)
    for name, (a, b) in pairs.items():
        check(bool(torch.isfinite(a.float()).all()),
              f"flash {dn} {shape}: non-finite {name}")
        e = (_err(a, b), _rel_err(a, b))
        check(e[1] <= FLASH_TOL[dn], f"flash {dn} {shape}: {name} relative "
              f"error {e[1]} > {FLASH_TOL[dn]}")
        worst = max(worst, e, key=lambda t: t[1])
    return worst


def _grads(prefix, got, want):
    return {f"{prefix}{n}": (a, b)
            for n, a, b in zip(("dQ", "dK", "dV"), got, want)}


def flash_phase(torch, timer, rows):
    """K1, K3a, K3b against their plain versions; returns the launch
    counts of the long-context route's public call (bf16)."""
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    long_launches = None
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for ci, (B, S, H, D, causal) in enumerate(FLASH_CASES):
            shape = [B, S, H, D, causal]
            q, k, v, do = _flash_inputs(torch, B, S, H, D, dtype, 41 + ci)
            scale = 1.0 / D ** 0.5
            o, lse = fa.flash_fwd(q, k, v, scale, causal)
            ro, rlse = fa.flash_fwd_ref(q, k, v, scale, causal)
            delta = (do.float() * ro.float()).sum(-1).transpose(
                1, 2).contiguous()
            bwd = (q, k, v, do, rlse, delta, scale, causal)
            want = fa.flash_bwd_ref(*bwd)
            fused = fa.flash_bwd_fused(*bwd)
            split = (fa.flash_bwd_dq(*bwd),) + tuple(fa.flash_bwd_dkv(*bwd))
            torch.cuda.synchronize()
            e_fwd = _flash_check(torch, dn, shape, {"O": (o, ro),
                                                    "lse": (lse, rlse)})
            e_fused = _flash_check(torch, dn, shape,
                                   _grads("fused ", fused, want))
            e_split = _flash_check(torch, dn, shape,
                                   _grads("split ", split, want))
            errs = {"K1": e_fwd, "K3a": e_fused, "K3b-dkv": e_split,
                    "K3b-dq": e_split}
            _flash_rows(torch, timer, rows, dn, shape, q, k, v, do, scale,
                        causal, errs)

        # the long-context route, through the public functional: the
        # counters must show the streaming pair and not the fused kernel
        B, S, H, D, causal = FLASH_LONG
        shape = [B, S, H, D, causal]
        q, k, v, do = _flash_inputs(torch, B, S, H, D, dtype, 47)
        ql, kl, vl = (x.clone().requires_grad_() for x in (q, k, v))
        fa.reset_launches()
        out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
        out.backward(do)
        torch.cuda.synchronize()
        got = dict(fa.launches)
        print(f"long-context route {dn} {shape}: launches {got}", flush=True)
        check(got == {"fwd": 1, "bwd_fused": 0, "bwd_dkv": 1, "bwd_dq": 1},
              f"long-context route launched {got}: expected the forward "
              "and the streaming dK/dV and dQ kernels once, the fused "
              "backward never")
        if dtype == torch.bfloat16:
            long_launches = got
        scale = 1.0 / D ** 0.5
        ro, rlse = fa.flash_fwd_ref(q, k, v, scale, causal)
        delta = (do.float() * ro.float()).sum(-1).transpose(1, 2).contiguous()
        want = fa.flash_bwd_ref(q, k, v, do, rlse, delta, scale, causal)
        e_fwd = _flash_check(torch, dn, shape, {"O": (out.detach(), ro)})
        e_split = _flash_check(torch, dn, shape, _grads(
            "split ", (ql.grad, kl.grad, vl.grad), want))
        fused = fa.flash_bwd_fused(q, k, v, do, rlse, delta, scale, causal)
        torch.cuda.synchronize()
        e_fused = _flash_check(torch, dn, shape, _grads("fused ", fused, want))
        _flash_rows(torch, timer, rows, dn, shape, q, k, v, do, scale, causal,
                    {"K1": e_fwd, "K3a": e_fused, "K3b-dkv": e_split,
                     "K3b-dq": e_split})
    return long_launches


def serving_phase(torch, card):
    from paddle_tpu_torch.inference import Request, ServingEngine
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_small
    from paddle_tpu_torch.ops.kernels import chunk_prefill as k5
    from paddle_tpu_torch.ops.kernels import layer_norm as k2
    from paddle_tpu_torch.ops.kernels import paged_attention as k4

    # fp32 end to end (no TF32, set in main): the greedy check below
    # compares two fp32 computations of the same logits
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
    # serving path; its attention takes the flash kernel K1 wherever the
    # gate of _local_attention allows (length >= 128 that tiles into
    # blocks of >= 64) and the plain _sdpa math elsewhere.
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


def training_phase(torch, card):
    """``bench.py``'s training run on the port: returns the launch counts
    of the 10 timed steps."""
    from paddle_tpu_torch.distributed import ShardedTrainer
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_small
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import layer_norm as k2
    from paddle_tpu_torch.optimizer import AdamW

    cfg = gpt2_small()
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    batch, seq, warm, steps = 16, 1024, 2, 10
    model = GPTForCausalLM(cfg, device="cuda", seed=0)
    model.train()
    ids_np = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                              (batch, seq))
    ids = torch.from_numpy(ids_np).cuda()

    # fp32 (amp off) loss of the first 2 rows on the card, through the
    # kernels, against the same weights on the CPU through the plain
    # versions; both sides fp32 with no TF32, differing in summation order
    cpu = GPTForCausalLM(cfg, device="cpu", seed=0)
    cpu.set_state_dict({n: t.detach().cpu().numpy()
                        for n, t in model.state_dict().items()})
    with torch.no_grad():
        card_loss = float(model(ids[:2], ids[:2]))
        cpu_loss = float(cpu(ids[:2].cpu(), ids[:2].cpu()))
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    print(f"fp32 2-row loss: card {card_loss!r}, cpu {cpu_loss!r}, "
          f"relative difference {rel:.3g} (limit 1e-4)", flush=True)
    check(rel <= 1e-4, f"card fp32 loss {card_loss} != cpu {cpu_loss}")
    del cpu

    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                weight_decay=0.01)
    trainer = ShardedTrainer(model, opt, None, amp=True)
    losses = [trainer.train_step(ids, ids) for _ in range(warm)]
    torch.cuda.synchronize()
    for m in (fa, k2):
        m.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(steps)]
    for start, end in ev:
        start.record()
        losses.append(trainer.train_step(ids, ids))
        end.record()
    torch.cuda.synchronize()
    launches = {"K1": fa.launches["fwd"], "K3a": fa.launches["bwd_fused"],
                "K3b-dkv": fa.launches["bwd_dkv"],
                "K3b-dq": fa.launches["bwd_dq"], "K2": k2.launches}
    step_ms = [s.elapsed_time(e) for s, e in ev]
    total_ms = ev[0][0].elapsed_time(ev[-1][1])
    vals = [float(x) for x in losses]
    print(f"training losses: {vals}", flush=True)
    check(all(np.isfinite(vals)), "non-finite training loss")
    check(vals[-1] < vals[0], f"loss did not fall: {vals[0]} -> {vals[-1]}")
    L = cfg.num_layers
    want = {"K1": L * steps, "K3a": L * steps, "K3b-dkv": 0, "K3b-dq": 0,
            "K2": (2 * L + 1) * steps}
    check(launches == want, f"training launch counts {launches} != {want} "
          f"for {steps} steps")
    tokens_per_s = batch * seq * steps / (total_ms / 1e3)
    mfu = tokens_per_s * 6 * cfg.num_params() / PEAK_FLOPS["bfloat16"]
    print(f"training on {card}: {tokens_per_s:.1f} tokens/s, step p50 "
          f"{float(np.median(step_ms)):.2f} ms (min {min(step_ms):.2f}, max "
          f"{max(step_ms):.2f}), MFU {mfu:.4f} (6 x {cfg.num_params()} "
          f"params / 989 TFLOP/s), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"launches over {steps} steps {launches}", flush=True)
    _profile_step(torch, trainer, ids, float(np.median(step_ms)))
    return launches


def _profile_step(torch, trainer, ids, step_ms):
    """Device time of one more training step by kernel, from
    ``torch.profiler`` (CUPTI): the largest kernels, and the device's
    busy share of the timed step p50."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_step(ids, ids)
        torch.cuda.synchronize()
    # device-side events only: an operator's own entry repeats the device
    # time of the kernels it launched
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in kernels)
    print(f"profiled step: device busy {busy:.2f} ms = "
          f"{busy / step_ms:.3f} of the step p50 {step_ms:.2f} ms; by "
          "kernel (ms, launches):", flush=True)
    for name, ms, n in sorted(kernels, key=lambda k: -k[1])[:15]:
        print(f"  {ms:9.3f} {n:6d}  {name[:90]}", flush=True)


_FA = "paddle_tpu/ops/pallas/flash_attention.py"
KERNELS = {
    "K1": ("flash_fwd", "paddle_tpu_torch/csrc/flash_fwd.cu",
           f"{_FA}:54, {_FA}:108"),
    "K2": ("layer_norm", "paddle_tpu_torch/csrc/layer_norm.cu",
           "paddle_tpu/ops/pallas/layer_norm.py:31"),
    "K3a": ("flash_bwd_fused", "paddle_tpu_torch/csrc/flash_bwd.cu",
            f"{_FA}:362"),
    "K3b-dkv": ("flash_bwd_dkv", "paddle_tpu_torch/csrc/flash_bwd.cu",
                f"{_FA}:162"),
    "K3b-dq": ("flash_bwd_dq", "paddle_tpu_torch/csrc/flash_bwd.cu",
               f"{_FA}:215"),
    "K4": ("paged_attention", "paddle_tpu_torch/csrc/paged_attention.cu",
           "paddle_tpu/ops/pallas/paged_attention.py:103"),
    "K5": ("chunk_prefill", "paddle_tpu_torch/csrc/chunk_prefill.cu",
           "paddle_tpu/ops/pallas/chunk_prefill.py:93"),
}
# the row each kernel reports in the kernels line: for K2, K4 and K5
# fp32 (the serving phase's dtype) at the decode shape for K2 and K4,
# and the deepest prefix for K5; for the flash kernels bf16 (the training
# phase's dtype under AMP) at the shape of the path that launches them
HEADLINE = {"K1": ("bfloat16", list(FLASH_CASES[0])),
            "K2": ("float32", [8, 768]),
            "K3a": ("bfloat16", list(FLASH_CASES[0])),
            "K3b-dkv": ("bfloat16", list(FLASH_LONG)),
            "K3b-dq": ("bfloat16", list(FLASH_LONG)),
            "K4": ("float32", [8, 1, 12, 64, 16, 64]),
            "K5": ("float32", [128, 517, 12, 64, 16, 64])}


def main():
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs the "
             "port on an NVIDIA card")
    # fp32 products in full fp32 everywhere: the fp32 comparisons hold
    # two fp32 computations of the same function to each other
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_phase(torch)
    build_phase()
    timer = Timer(torch)
    rows = []
    print("kernels vs plain versions (device ms, cold L2):", flush=True)
    layer_norm_phase(torch, timer, rows)
    paged_phase(torch, timer, rows)
    chunk_phase(torch, timer, rows)
    long_launches = flash_phase(torch, timer, rows)
    launches = serving_phase(torch, card)
    train_launches = training_phase(torch, card)
    launches.update({"K1": train_launches["K1"], "K3a": train_launches["K3a"],
                     "K3b-dkv": long_launches["bwd_dkv"],
                     "K3b-dq": long_launches["bwd_dq"]})

    out = []
    for kid, (name, src, replaces) in KERNELS.items():
        row = next(r for r in rows if r["kernel"] == kid
                   and [r["dtype"], r["shape"]] == list(HEADLINE[kid]))
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
