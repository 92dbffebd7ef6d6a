#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
NVIDIA Hopper card (compute capability 9.0), the CUDA toolkit's ``nvcc``
and PyTorch built for CUDA; it imports nothing of JAX or ``paddle_tpu``.
Phases, in order (any failure exits non-zero and prints no result):

1. card: the ``nvidia-smi`` name and power limit, the capability;
2. build: ``csrc/*.cu`` -> ``build/kernels/`` with ``nvcc`` for sm_90a,
   then the registers and spills of every K1/K4/K5 instantiation
   (``-Xptxas -v``; a bf16 K1 that spills fails the run) and the bf16
   K1's shared memory and CTAs per SM from the CUDA runtime;
3. kernels: K2 LayerNorm, K4 paged decode and K5 chunk prefill, each
   against its plain PyTorch version in fp32 and bf16 at the serving
   path's shapes, on pools poisoned where no query may read (1e9 in
   unreadable rows of mapped blocks, NaN in blocks no table names; for
   the kernel alone also NaN in every unreadable row), with
   device times beside the plain version, one library call and the
   card's lower bound; then the int8 branches of K4 and K5 on int8 code
   pools with (block, head) scales, poisoned with saturated codes (127)
   in every row no query may read and a 1e7 scale in every block no
   table names (NaN scales there for the kernel alone);
4. flash: K1 (forward), K3a (fused backward) and K3b (the streaming
   dK/dV and dQ passes) against their plain versions in fp32 and bf16
   at the training shape, non-causal, at head_dim 128, and on the
   long-context route (S 8320, through ``F.scaled_dot_product_attention``
   and ``.backward()``, whose launch counters must show the streaming
   pair and not the fused kernel), with the same timings; K1 also on
   ragged lengths, Sq != Sk, GPT's per-head qkv views (taken without a
   copy), a view misaligned by one element (copied for bf16) and inputs
   with NaN past S, and a misaligned pointer that its C entry point must
   refuse; every K1 case is held to FLASH_TOL and to K1_TOL (lse
   absolutely, O element by element);
5. serving: ``gpt2_small`` at full width and depth (random weights from a
   seed) serves 16 requests through ``ServingEngine`` on the card; the
   kernels' launch counters must equal what the engine's own chunk and
   step counts imply, and every greedy token must equal the argmax of a
   teacher-forced no-cache forward (near-ties counted, not failed);
5b. int8 serving with the prefix cache: the same model behind
   ``ServingEngine(kv_dtype="int8", prefix_cache=PrefixCache(...))``
   serves 16 requests that share a 512-token system prompt; the int8
   kernels' counters must equal the chunk and step counts (the fp ones
   stay 0), the trie must hold every block left in use, the greedy
   tokens must equal a run of the same trace with the cache off, and
   their agreement with the fp32 teacher-forced argmax must reach 0.9;
6. training: ``gpt2_small`` at full width and depth, batch 16 x 1024,
   ``AdamW`` and ``ShardedTrainer(amp=True)`` (the configuration of
   ``bench.py``), 2 warm-up and 10 timed steps: a finite, falling loss,
   exact launch counts per step, and an fp32 forward on the card equal
   to the same forward on the CPU; tokens/s, step p50 and MFU;
7. the ``kernels`` JSON line, then the ``ok`` line.
"""

from __future__ import annotations

import json
import re
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

# K1 is held to more than FLASH_TOL: lse on its own, absolutely, and O
# element by element, |O - plain| <= atol + rtol * |plain|. Under causal
# masking |O| falls from |v[0]| in row 0 to ~0.07 past row 500 (S 1000),
# so a limit relative to max |plain| lets a late row lose a whole key
# tile; these do not. bf16 O differs by one rounding of each side to
# bf16 (rtol) plus P rounded at another running max (atol); lse and fp32
# O differ in summation order only. Over every K1 case of this script on
# an H100 the sound kernel's worst errors are lse 1.9e-6 (both dtypes),
# bf16 O 1.06e-3 + 1e-2 |plain|, fp32 O 6.8e-7 + 1e-5 |plain|
# (k1_fault_check.py, PERF.md); the limits sit 3-5x above them, and that
# script shows each planted fault that changes an output failing them.
K1_TOL = {"float32": {"lse": 1e-5, "atol": 3e-6, "rtol": 1e-5},
          "bfloat16": {"lse": 1e-5, "atol": 3e-3, "rtol": 1e-2}}


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
    finds its inputs cold, as one layer's pools are in a real step. A
    call that launches many kernels gets fewer calls per measurement:
    a stream holds ~1024 pending launches, and past that the host
    blocks in the launch until the device drains the queue."""

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
            n = max(10, n // 2)
            check(self.cycles < 8_000_000_000,
                  f"could not enqueue {n} calls ahead of the device")


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


_PTXAS_PAGED = re.compile(r"paged_attn_kernelI(f|13__nv_bfloat16)"
                          r"(f|a|S\d*_)Li(\d+)ELi\d+ELi\d+E")
_PTXAS_FLASH = re.compile(r"flash_fwd_(mma_)?kernelI(f)?Li(\d+)E")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def _k1_occupancy(D: int) -> str:
    """The bf16 K1's shared memory and the CTAs of it an SM holds, as
    the CUDA runtime computes them for the built kernel."""
    import ctypes

    from paddle_tpu_torch.ops.kernels import _build

    ctas, smem = ctypes.c_int(), ctypes.c_int()
    err = _build.load_library().ptt_flash_fwd_occupancy(
        D, ctypes.byref(ctas), ctypes.byref(smem))
    check(err == 0, f"K1 occupancy query failed (cudaError {err})")
    return (f", {smem.value} bytes shared memory, {ctas.value} CTAs per SM "
            "(CUDA runtime)")


def _ptxas_label(src: str, name):
    """What a matched kernel name is, and whether it is a bf16 K1."""
    if src == "flash_fwd.cu":
        bf16 = name.group(1) is not None
        return (f"K1 {'bf16 mma.sync' if bf16 else 'fp32 CUDA cores'}, D "
                f"{name.group(3)}", bf16)
    tq = "fp32" if name.group(1) == "f" else "bf16"
    tp = "int8" if name.group(2) == "a" else tq
    return f"q {tq}, pool {tp}, D {name.group(3)}", False


def ptxas_phase():
    """Registers and spills of every K1, K4 and K5 instantiation, from
    ``nvcc -Xptxas -v`` on their sources; a bf16 K1 that spills fails
    the run. For the bf16 K1 also its shared memory and the CTAs an SM
    holds."""
    import tempfile

    from paddle_tpu_torch.ops.kernels import _build

    pats = {"paged_attention.cu": _PTXAS_PAGED,
            "chunk_prefill.cu": _PTXAS_PAGED, "flash_fwd.cu": _PTXAS_FLASH}
    srcs = [p for p in _build.sources() if p.name in pats]
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
             str(src), "-o", f"{tmp}/{src.stem}.o"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src in srcs]
        outs = [p.communicate(timeout=600)[0] for p in procs]
    k1_seen = 0
    for src, proc, out in zip(srcs, procs, outs):
        check(proc.returncode == 0, f"nvcc -Xptxas -v {src.name}:\n{out}")
        name = spill = None
        for line in out.splitlines():
            if "Compiling entry function" in line:
                name = pats[src.name].search(line)
            elif name is not None and "spill" in line:
                spill = _SPILL.search(line)
            elif name is not None and "Used" in line:
                label, mma = _ptxas_label(src.name, name)
                regs = int(line.split("Used", 1)[1].split()[0])
                stores, loads = int(spill.group(1)), int(spill.group(2))
                extra = ""
                if mma:
                    k1_seen += 1
                    extra = _k1_occupancy(int(name.group(3)))
                    check(stores == loads == 0, f"ptxas: {label} spills "
                          f"{stores} bytes stored, {loads} loaded")
                print(f"ptxas {src.name}: {label}: {regs} registers, "
                      f"{stores} bytes spill stores, {loads} bytes spill "
                      f"loads{extra}", flush=True)
                name = None
    check(k1_seen == 2, f"ptxas: {k1_seen} bf16 K1 instantiations seen, "
          "expected D 64 and D 128")


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


def _pool_case_q(torch, rs, nslots, bp, bs, H, D, spare=16):
    """int8 pools of random codes with (block, head) scales of a
    quantized commit's size (absmax / 127 of unit-normal rows), and a
    table of distinct blocks as :func:`_pool_case` draws it."""
    nblk = 1 + nslots * bp + spare
    table = (1 + rs.permutation(nblk - 1)[:nslots * bp]).reshape(
        nslots, bp).astype(np.int32)
    codes = [torch.from_numpy(rs.randint(-127, 128, (nblk, bs, H, D)).astype(
        np.int8)).cuda() for _ in range(2)]
    scales = [torch.from_numpy((0.02 + 0.01 * np.abs(rs.randn(nblk, H))
                                ).astype(np.float32)).cuda()
              for _ in range(2)]
    return codes, scales, torch.from_numpy(table).cuda(), table


def _poison_q(torch, codes, scales, table, reach, dead_scale=1e7):
    """Saturated codes (127) in every pool row no (slot, table entry) can
    read under ``col <= reach[slot]``; ``dead_scale`` in every scale row
    of a block no table names (NaN only for the kernel alone: the plain
    version gathers named blocks only, but a block no table names is
    never read by either)."""
    nblk, bs = codes[0].shape[0], codes[0].shape[1]
    readable = np.zeros((nblk, bs), bool)
    named = np.zeros((nblk,), bool)
    cols = np.arange(table.shape[1] * bs)
    for o in range(table.shape[0]):
        named[table[o]] = True
        ok = cols <= reach[o]
        readable[table[o][cols[ok] // bs], cols[ok] % bs] = True
    rows_dead = torch.from_numpy(~readable).cuda()
    unnamed = torch.from_numpy(~named).cuda()
    codes = [c.clone() for c in codes]
    scales = [x.clone() for x in scales]
    for c, x in zip(codes, scales):
        c[rows_dead] = 127
        x[unnamed] = dead_scale
    return codes, scales


def _attention_case_q(torch, timer, rows, name, kernel_fn, ref_fn, q, codes,
                      scales, table_t, table, t, reach, dn, shape, nbytes,
                      flops):
    """The int8 branch of K4/K5 against its plain version: clean pools,
    poisoned pools (1e7 scales), and the kernel alone with NaN scales in
    every block no table names."""
    import torch.nn.functional as TF

    def kern(c, x):
        return kernel_fn(q, c[0], c[1], table_t, t, k_scale=x[0],
                         v_scale=x[1])

    def plain(c, x):
        return ref_fn(q, c[0], c[1], table_t, t, k_scale=x[0], v_scale=x[1])

    out, ref = kern(codes, scales), plain(codes, scales)
    pc, px = _poison_q(torch, codes, scales, table, reach)
    out_p, ref_p = kern(pc, px), plain(pc, px)
    nc, nx = _poison_q(torch, codes, scales, table, reach,
                       dead_scale=float("nan"))
    out_n = kern(nc, nx)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out_p).all() and torch.isfinite(out_n).all()),
          f"{name} {dn} {shape}: non-finite output on a poisoned pool")
    # bf16: relative to max(1, max |plain|); the plain version casts the
    # dequantized view to bf16 (the reference's order), the kernel keeps
    # it in fp32 (the Pallas kernel's)
    err = max(_err(out, ref), _err(out_p, ref_p), _err(out_p, out),
              _err(out_n, out))
    norm = max(1.0, float(ref.float().abs().max())) \
        if dn == "bfloat16" else 1.0
    check(err / norm <= ATOL[dn], f"{name} {dn} {shape}: max |kernel - "
          f"plain| {err} (/ {norm}) > {ATOL[dn]} (clean, poisoned, or "
          "poisoned vs clean)")
    # library yardstick: SDPA over the dense view dequantized beforehand
    # (neither the gather nor the dequant is timed)
    b, s = q.shape[0], q.shape[1]
    nrows = min(int(max(reach)) + 1, table.shape[1] * codes[0].shape[1])
    kp, vp = ((c.float() * x[:, None, :, None]).to(q.dtype)
              for c, x in zip(codes, scales))
    kd, vd = _dense_view(torch, kp, vp, table_t, nrows)
    qd = q.transpose(1, 2).contiguous()
    tt = torch.as_tensor(t, device="cuda").reshape(-1, 1, 1, 1)
    mask = (torch.arange(nrows, device="cuda")[None, None, None, :]
            <= tt + torch.arange(s, device="cuda")[None, None, :, None])
    _record(rows, name, dn, shape, err, timer, lambda: kern(codes, scales),
            lambda: plain(codes, scales),
            lambda: TF.scaled_dot_product_attention(qd, kd, vd,
                                                    attn_mask=mask),
            nbytes=nbytes, flops=flops)


def _q_bytes(H, D, bs, rows_read, blocks_read, q_rows, sz, table_nbytes):
    """Bytes an int8 case must move: the codes of the rows it reads (1
    byte an element, K and V), one fp32 scale per (block, head) read,
    q in and out at q's size, the table."""
    return (rows_read * H * D * 2 + blocks_read * H * 4 * 2
            + 2 * q_rows * H * D * sz + table_nbytes)


def paged_q_phase(torch, timer, rows):
    from paddle_tpu_torch.ops.kernels import paged_attention as k4

    b, s, H, D, bs, bp = 8, 1, 12, 64, 16, 64
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        rs = np.random.RandomState(22)
        codes, scales, table_t, table = _pool_case_q(torch, rs, b, bp, bs,
                                                     H, D)
        t_np = np.linspace(0, 1000, b).round().astype(np.int32)
        rs.shuffle(t_np)
        t = torch.from_numpy(t_np).cuda()
        q = torch.from_numpy(rs.randn(b, s, H, D).astype(np.float32)).to(
            "cuda", dtype)
        keys = t_np + s
        nbytes = _q_bytes(H, D, bs, int(keys.sum()),
                          int(((keys - 1) // bs + 1).sum()), b * s,
                          q.element_size(), table.nbytes + 4 * b)
        flops = 4 * s * int(keys.sum()) * H * D
        _attention_case_q(torch, timer, rows, "K4-int8", k4.paged_attention,
                          k4.paged_attention_ref, q, codes, scales, table_t,
                          table, t, t_np + s - 1, dn, [b, s, H, D, bs, bp],
                          nbytes, flops)


def chunk_q_phase(torch, timer, rows):
    from paddle_tpu_torch.ops.kernels import chunk_prefill as k5

    H, D, bs, bp = 12, 64, 16, 64
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for s, start in ((128, 0), (128, 517)):
            rs = np.random.RandomState(32 + start + s)
            codes, scales, table_t, table = _pool_case_q(torch, rs, 1, bp,
                                                         bs, H, D)
            q = torch.from_numpy(rs.randn(1, s, H, D).astype(
                np.float32)).to("cuda", dtype)
            t = torch.tensor(start, dtype=torch.int32, device="cuda")
            keys = min(start + s, bp * bs)
            nbytes = _q_bytes(H, D, bs, keys, (keys - 1) // bs + 1, s,
                              q.element_size(), table.nbytes)
            flops = 4 * H * D * sum(min(start + i + 1, keys)
                                    for i in range(s))
            _attention_case_q(torch, timer, rows, "K5-int8",
                              k5.chunk_prefill, k5.chunk_prefill_ref, q,
                              codes, scales, table_t, table, t,
                              [start + s - 1], dn, [s, start, H, D, bs, bp],
                              nbytes, flops)


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
        if kid == "K1":
            row.update(lse_err=errs[kid][2], o_limit_share=errs[kid][3],
                       k1_tol=K1_TOL[dn])
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


def k1_errors(dn, o, ro, lse, rlse):
    """K1's own measures against its plain version: lse's max |err|, and
    the largest |O - plain| / (atol + rtol * |plain|) of any element
    (NaN if any O is not finite)."""
    tol = K1_TOL[dn]
    ro = ro.float()
    ratio = (o.float() - ro).abs() / (tol["atol"] + tol["rtol"] * ro.abs())
    return _err(lse, rlse), float(ratio.max())


def k1_passes(dn, o, ro, lse, rlse) -> bool:
    e_lse, ratio = k1_errors(dn, o, ro, lse, rlse)
    return e_lse <= K1_TOL[dn]["lse"] and ratio <= 1.0


def _k1_check(torch, dn, shape, o, ro, lse, rlse):
    """FLASH_TOL on O and lse, then K1's own limits; returns (max |err|,
    relative err, lse's max |err|, O's largest share of its limit)."""
    worst = _flash_check(torch, dn, shape, {"O": (o, ro), "lse": (lse, rlse)})
    e_lse, ratio = k1_errors(dn, o, ro, lse, rlse)
    check(e_lse <= K1_TOL[dn]["lse"], f"K1 {dn} {shape}: max |lse - plain| "
          f"{e_lse} > {K1_TOL[dn]['lse']}")
    check(ratio <= 1.0, f"K1 {dn} {shape}: an element of O is off by "
          f"{ratio} x (atol {K1_TOL[dn]['atol']} + rtol "
          f"{K1_TOL[dn]['rtol']} |plain|)")
    return worst + (e_lse, ratio)


def k1_case_inputs(torch, dtype):
    """(name, (q, k, v), causal, layout) of every K1 case beyond the timed
    shapes: ragged lengths, Sq != Sk, GPT's strided per-head views
    (``layout`` "kept": the gate takes them without a copy), a view
    misaligned by one element ("copied" for bf16), and inputs sliced from
    a buffer whose rows past S hold NaN."""
    g = torch.Generator(device="cuda").manual_seed(53)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)

    # ragged: the public gate sends S 1000 to flash (_pick_block(1000,
    # 256) = 250); neither length is a multiple of a 64- or 128-row tile
    for S, D, causal in ((1000, 64, True), (200, 128, False)):
        yield (f"ragged S {S} D {D} causal {causal}",
               (rand(2, S, 4, D), rand(2, S, 4, D), rand(2, S, 4, D)),
               causal, None)
    for causal in (True, False):
        yield (f"Sq 256 Sk 1024 causal {causal}",
               (rand(2, 256, 4, 64), rand(2, 1024, 4, 64),
                rand(2, 1024, 4, 64)), causal, None)
    # GPT's views (models/gpt.py: qkv.split(head_dim, -1) per head)
    B, S, H, D = 2, 1024, 12, 64
    yield ("GPT qkv views", rand(B, S, H, 3 * D).split(D, dim=-1), True,
           "kept")
    # one element past an aligned base
    n = B * S * H * D
    yield ("misaligned view",
           tuple(rand(n + 1)[1:].view(B, S, H, D) for _ in range(3)), True,
           "copied" if dtype == torch.bfloat16 else "kept")
    # NaN past S: a CTA whose tile runs past S must not read those rows
    S, pad = 1000, 64
    bufs = []
    for _ in range(3):
        buf = torch.full((B, S + pad, H, D), float("nan"), device="cuda",
                         dtype=dtype)
        buf[:, :S] = rand(B, S, H, D)
        bufs.append(buf[:, :S])
    for causal in (True, False):
        yield f"NaN past S {S} causal {causal}", tuple(bufs), causal, None


def k1_cases(torch, dtype):
    """Every case of :func:`k1_case_inputs` through the public wrapper
    against the plain version on the same views, with the layout gate's
    verdict checked; then a misaligned pointer handed to the C entry
    point, which must refuse it."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    dn = str(dtype).split(".")[1]
    for name, qkv, causal, layout in k1_case_inputs(torch, dtype):
        if layout is not None:
            got = fa.kernel_layout(*qkv, cp_async=True)
            kept = [t.data_ptr() for t in got] == [t.data_ptr() for t in qkv]
            check(kept == (layout == "kept"), f"K1 {dn} {name}: the layout "
                  f"gate's views were not {layout}")
            check(dtype != torch.bfloat16 or all(
                t.data_ptr() % 16 == 0 for t in got),
                f"K1 bf16 {name}: the layout gate passed a misaligned view")
        scale = 1.0 / qkv[0].shape[-1] ** 0.5
        o, lse = fa.flash_fwd(*qkv, scale, causal)
        ro, rlse = fa.flash_fwd_ref(*qkv, scale, causal)
        torch.cuda.synchronize()
        err = _k1_check(torch, dn, name, o, ro, lse, rlse)
        print(f"  K1 {dn} {name}: max |err| {err[0]:.3g}, relative "
              f"{err[1]:.3g}, lse {err[2]:.3g}, O at {err[3]:.3g} of its "
              "limit", flush=True)
    # a misaligned pointer that reaches the entry point: refused
    # (cudaErrorInvalidValue = 1) for bf16, and the wrapper's check raises
    if dtype == torch.bfloat16:
        q = torch.zeros(1, 128, 1, 64, device="cuda", dtype=dtype)
        o = torch.empty_like(q)
        lse = torch.empty(1, 1, 128, device="cuda")
        err = _build.load_library().ptt_flash_fwd(
            q.data_ptr() + 2, q.data_ptr(), q.data_ptr(), o.data_ptr(),
            lse.data_ptr(), *fa._tail(q, q, 0.125, True))
        check(err == 1, f"K1 bf16 took a misaligned pointer (returned {err})")
        try:
            _build.check(err, "flash forward kernel")
            fail("a refused K1 launch did not raise")
        except RuntimeError:
            pass
        print("  K1 bf16 misaligned pointer: refused at the entry point "
              f"(cudaError {err}), the wrapper raises", flush=True)


def flash_phase(torch, timer, rows):
    """K1, K3a, K3b against their plain versions; returns the launch
    counts of the long-context route's public call (bf16)."""
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    long_launches = None
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        k1_cases(torch, dtype)
        for ci, (B, S, H, D, causal) in enumerate(FLASH_CASES):
            shape = [B, S, H, D, causal]
            q, k, v, do = _flash_inputs(torch, B, S, H, D, dtype, 41 + ci)
            scale = 1.0 / D ** 0.5
            o, lse = fa.flash_fwd(q, k, v, scale, causal)
            ro, rlse = fa.flash_fwd_ref(q, k, v, scale, causal)
            delta = (do.float() * ro.float()).sum(-1).transpose(
                1, 2).contiguous()
            want = fa.flash_bwd_ref(q, k, v, do, rlse, delta, scale, causal)
            # the backward kernels recompute P from K1's lse, as in training
            bwd = (q, k, v, do, lse, delta, scale, causal)
            fused = fa.flash_bwd_fused(*bwd)
            split = (fa.flash_bwd_dq(*bwd),) + tuple(fa.flash_bwd_dkv(*bwd))
            torch.cuda.synchronize()
            e_fwd = _k1_check(torch, dn, shape, o, ro, lse, rlse)
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
        # lse from the same kernel on the same inputs, outside the count
        lse = fa.flash_fwd(q, k, v, scale, causal)[1]
        e_fwd = _k1_check(torch, dn, shape, out.detach(), ro, lse, rlse)
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
    check(k4.launches_q == k5.launches_q == 0,
          "fp32 pools launched an int8 kernel")

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
          f"step p50 {agg['decode_step_ms_p50']:.2f} ms, wall {wall:.2f} s, "
          f"kv_bytes_in_use_peak {int(agg['kv_bytes_in_use_peak'])}",
          flush=True)
    return launches, model, agg


def _shared_prefix_trace(vocab):
    """16 requests from ``RandomState(1)``: one 512-token system prompt,
    then a 24-300-token suffix each; 32-64 new tokens; 12 greedy, 4 at
    temperature 0.8 / top-p 0.9. Returned as Request keyword dicts."""
    rs = np.random.RandomState(1)
    system = rs.randint(0, vocab, 512).tolist()
    sampled = set(rs.choice(16, 4, replace=False).tolist())
    out = []
    for i in range(16):
        suffix = rs.randint(0, vocab, int(rs.randint(24, 301))).tolist()
        kw = (dict(temperature=0.8, top_p=0.9) if i in sampled
              else dict(greedy=True))
        out.append(dict(prompt=system + suffix,
                        max_new_tokens=int(rs.randint(32, 65)), **kw))
    return out


def _serve_q(torch, model, trace, cache):
    """One int8 run of ``trace`` (after a warm-up request): the requests,
    their streams, the aggregate, the wall seconds and the launch counts
    of the run (every counter set to 0 just before it)."""
    from paddle_tpu_torch.inference import Request, ServingEngine
    from paddle_tpu_torch.ops.kernels import chunk_prefill as k5
    from paddle_tpu_torch.ops.kernels import layer_norm as k2
    from paddle_tpu_torch.ops.kernels import paged_attention as k4

    eng = ServingEngine(model, max_batch_slots=8, max_len=1024,
                        block_size=16, prefill_chunk=128, seed=0,
                        kv_dtype="int8", prefix_cache=cache, device="cuda")
    eng.submit(Request(prompt=[1, 2, 3], max_new_tokens=4, greedy=True))
    eng.run()
    streamed = {}
    reqs = [eng.submit(Request(on_token=lambda r, tok, done: streamed.
                               setdefault(r.id, []).append((tok, bool(done))),
                               **kw)) for kw in trace]
    torch.cuda.synchronize()
    for m in (k2, k4, k5):
        m.reset_launches()
    t0 = time.perf_counter()
    agg = eng.run().aggregate()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K2": k2.launches, "K4": k4.launches, "K5": k5.launches,
                "K4-int8": k4.launches_q, "K5-int8": k5.launches_q}
    return eng, reqs, streamed, agg, wall, launches


def serving_q_phase(torch, card, model, fp_agg):
    """Phase 5b: int8 pools and the prefix cache on the same model;
    returns the int8 kernels' launch counts."""
    from paddle_tpu_torch.inference import PrefixCache

    cfg = model.config
    L = cfg.num_layers
    trace = _shared_prefix_trace(cfg.vocab_size)
    cache = PrefixCache(chunk_tokens=128, max_bytes=1 << 30)
    eng, reqs, streamed, agg, wall, launches = _serve_q(torch, model, trace,
                                                        cache)
    # the warm-up prompt is shorter than a chunk: it cached nothing and
    # hit nothing, so the trie's counter is the run's
    chunks, steps = int(agg["prefill_chunks"]), int(agg["decode_steps"])
    hits = int(agg["prefix_hit_tokens"])
    print(f"int8 + prefix cache: {int(agg['completed'])} requests, {chunks} "
          f"prefill chunks, {steps} decode steps, "
          f"{int(agg['preemptions'])} preemptions, prefix hit tokens "
          f"{hits} (rate {agg['prefix_hit_rate']:.3f}), evictions "
          f"{int(agg['evictions'])}, launches {launches}", flush=True)
    for r in reqs:
        check(r.status == "done" and r.finish_reason in ("length", "eos"),
              f"int8 request {r.id} ended {r.status}/{r.finish_reason}")
        check([tk for tk, _ in streamed[r.id]] == r.tokens
              and streamed[r.id][-1][1],
              f"int8 request {r.id}: the stream differs from its tokens")
    want = {"K2": (2 * L + 1) * (chunks + steps), "K4": 0, "K5": 0,
            "K4-int8": L * steps, "K5-int8": L * chunks}
    check(launches == want, f"int8 launch counts {launches} != {want} "
          f"implied by {chunks} chunks and {steps} steps")
    check(hits > 0 and hits == cache.hit_tokens,
          f"prefix hit tokens {hits}, the trie's {cache.hit_tokens}")
    held = {b for n in cache.iter_nodes() for b in n.blocks}
    check(eng._alloc.blocks_in_use() == len(held),
          f"{eng._alloc.blocks_in_use()} blocks in use after the run, the "
          f"trie holds {len(held)}")

    # the same trace with the cache off, on int8 pools: token-exact for
    # the greedy requests (chunk_tokens == prefill_chunk, so a spliced
    # prefix holds the codes a cold prefill commits)
    _, cold, _, cold_agg, _, _ = _serve_q(torch, model, trace, None)
    for r, c in zip(reqs, cold):
        if r.greedy:
            check(r.tokens == c.tokens, f"int8 request {r.id}: cache on "
                  f"{r.tokens[:8]}... != cache off {c.tokens[:8]}...")
    print(f"cache on vs off (int8): greedy tokens equal; prefill chunks "
          f"{chunks} vs {int(cold_agg['prefill_chunks'])}", flush=True)

    # agreement with the fp32 teacher-forced no-cache argmax; the limit
    # is the reference's int8 contract (test_paged_kv.py:502)
    agree = total = 0
    with torch.inference_mode():
        for r in reqs:
            if not r.greedy:
                continue
            ids = torch.tensor([list(r.prompt) + r.tokens[:-1]],
                               device="cuda")
            arg = model(ids)[0, len(r.prompt) - 1:].argmax(-1).cpu().numpy()
            agree += int((arg == np.asarray(r.tokens)).sum())
            total += len(r.tokens)
    rate = agree / total
    print(f"int8 greedy agreement with the fp32 argmax: {agree}/{total} = "
          f"{rate:.4f} (limit 0.9)", flush=True)
    check(rate >= 0.9, f"int8 greedy agreement {rate} < 0.9")
    print(f"int8 serving perf on {card}: {agg['aggregate_tokens_per_s']:.1f} "
          f"tokens/s, TTFT p50 {agg['ttft_p50_s'] * 1e3:.1f} ms, decode "
          f"step p50 {agg['decode_step_ms_p50']:.2f} ms, wall {wall:.2f} s, "
          f"kv_bytes_in_use_peak {int(agg['kv_bytes_in_use_peak'])} (phase 5, "
          f"fp32: {int(fp_agg['kv_bytes_in_use_peak'])}); cache off: "
          f"{cold_agg['aggregate_tokens_per_s']:.1f} tokens/s, TTFT p50 "
          f"{cold_agg['ttft_p50_s'] * 1e3:.1f} ms, kv_bytes_in_use_peak "
          f"{int(cold_agg['kv_bytes_in_use_peak'])}", flush=True)
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
    "K4-int8": ("paged_attention", "paddle_tpu_torch/csrc/paged_attention.cu",
                "paddle_tpu/ops/pallas/paged_attention.py:134"),
    "K5-int8": ("chunk_prefill", "paddle_tpu_torch/csrc/chunk_prefill.cu",
                "paddle_tpu/ops/pallas/chunk_prefill.py:126"),
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
            "K5": ("float32", [128, 517, 12, 64, 16, 64]),
            "K4-int8": ("float32", [8, 1, 12, 64, 16, 64]),
            "K5-int8": ("float32", [128, 517, 12, 64, 16, 64])}


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
    ptxas_phase()
    timer = Timer(torch)
    rows = []
    print("kernels vs plain versions (device ms, cold L2):", flush=True)
    layer_norm_phase(torch, timer, rows)
    paged_phase(torch, timer, rows)
    chunk_phase(torch, timer, rows)
    paged_q_phase(torch, timer, rows)
    chunk_q_phase(torch, timer, rows)
    long_launches = flash_phase(torch, timer, rows)
    launches, model, fp_agg = serving_phase(torch, card)
    q_launches = serving_q_phase(torch, card, model, fp_agg)
    launches.update({k: q_launches[k] for k in ("K4-int8", "K5-int8")})
    del model
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
