#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
NVIDIA Hopper card (compute capability 9.0), the CUDA toolkit's ``nvcc``
and PyTorch built for CUDA; it imports nothing of JAX or ``paddle_tpu``.
Phases, in order (any failure exits non-zero and prints no result):

1. card: the ``nvidia-smi`` name and power limit, the capability;
2. build: ``csrc/*.cu`` -> ``build/kernels/`` with ``nvcc`` for sm_90a,
   then the registers and spills of every K1/K3/K4/K5 instantiation
   (``-Xptxas -v``; a bf16 K1, K3a, K3b-dkv, K3b-dq, K4 or K5 body, or an
   instantiation of the fp32 paged body, that spills fails the run), the
   tensor-core instructions (HMMA) and atomics (RED, ATOM) that
   ``cuobjdump -sass`` finds in each bf16 K3, K4 and K5 body and in the
   fp32 paged body (no HMMA in a bf16 body fails the run, and so do
   atomics in the K3b-dq body, whose dQ is written once, and any HMMA in
   the fp32 body), and the bf16 K1's, K3 and K5 bodies' shared memory and
   CTAs per SM from the CUDA runtime (K4's: the clusters the card holds
   at once);
3. kernels: K2 LayerNorm (also at a large mean, an odd C and on an
   offset view, with and without w and b, each held to K2_TOL as well),
   K4 paged decode and K5 chunk prefill, each
   against its plain PyTorch version in fp32 and bf16 at the serving
   path's shapes, on pools poisoned where no query may read (1e9 in
   unreadable rows of mapped blocks, NaN in blocks no table names; for
   the kernel alone also NaN in every unreadable row), with
   device times beside the plain version, one library call and the
   card's lower bound; then the int8 branches of K4 and K5 on int8 code
   pools with (block, head) scales, poisoned with saturated codes (127)
   in every row no query may read and a 1e7 scale in every block no
   table names (NaN scales there for the kernel alone). K4 at the decode
   step (8 slots), a lone request at t 1000, a verify of 4 drafts (s 5)
   and slots running off tables of 5 blocks of 16 rows (s 5) and 3 of 11
   (s 16), over both pools; K5 also
   on a chunk running off a table of 5 blocks, and with bf16 q (its
   tensor-core body) on three slots at their own starts. Every bf16 K4
   case is held to K4_TOL, every bf16 K5 case to K5_TOL and every fp32
   K4 and K5 case to F32_PAGED_TOL as well, element by element, and a
   bf16 q, or an fp32 q's K pool, misaligned for cp.async must be refused
   by K4's and by K5's C entry point;
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
   absolutely, O element by element); K3a, K3b-dkv and K3b-dq on the
   same cases (with a dO, lse from K1 as in training), on the timed
   shapes and at S 8320, each held to FLASH_TOL and to K3_TOL (dQ, dK,
   dV element by element), and misaligned pointers their C entry points
   must refuse; SDPA's backward alone (and its forward + backward) is
   the K3 rows' yardstick;
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
5c. bf16 serving: ``gpt2_small`` in bf16 (full width and depth) serves
   phase 5's first 8 greedy requests on bf16 pools, then on int8 pools,
   so that prefill runs K5's and decode K4's tensor-core bodies end to
   end: exact launch counts, and greedy agreement with the bf16
   teacher-forced argmax of at least 0.9;
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

# The K3 kernels (K3a, K3b-dkv, K3b-dq) are held to more than FLASH_TOL
# too: each of dQ, dK and dV element by element, |out - plain| <= atol +
# rtol * |plain|, so a dropped query or key tile or a lost warp of dQ
# cannot hide under a limit relative to the largest gradient. bf16
# differs by one rounding of each side to bf16 (rtol) plus P and dS
# rounded to bf16 from logits that differ in the last fp32 bits (atol; dV
# sums P, the largest such term); fp32 differs in summation order, and
# K3a's dQ also in the order of its fp32 atomics, which changes from run
# to run (K3b-dq writes dQ once: its spread is 0). The limits sit 3-5x
# above the sound kernels' worst errors over every K3 case of this script
# on an H100, over several runs (k3_fault_check.py, PERF.md); K3b-dq's
# worst dQ (bf16 8.9e-4, fp32 2.0e-6) is K3a's, so one dQ limit holds
# both, at 4.5x and 4.0x.
K3_TOL = {"float32": {"rtol": 1e-5,
                      "atol": {"dQ": 8e-6, "dK": 5e-6, "dV": 4e-6}},
          "bfloat16": {"rtol": 1e-2,
                       "atol": {"dQ": 4e-3, "dK": 4e-3, "dV": 1.5e-2}}}


# K5's bf16 body (q bf16; bf16 pools, or int8 codes with their scales)
# is held to more than ATOL too: element by element, |out - plain| <=
# atol + rtol |plain|, against the plain version evaluated in fp32 on the
# same values (int8 codes dequantized in fp32, as the kernel folds the
# scales), on clean, poisoned and NaN-poisoned pools. The two differ by
# one rounding of the output to bf16 (rtol) and by P rounded before P.V
# (atol): to bf16 over bf16 pools, to fp16 over int8 pools, whose values
# reach the blocks' absmax. Over every K5 case of this script on an
# H100 the sound body's worst errors are 1.88e-3 + 1e-2 |plain| over
# bf16 pools and 6.0e-4 + 1e-2 |plain| over int8 pools
# (k5_fault_check.py, PERF.md); the limits sit 3.2x and 3.3x above them,
# and that script shows each planted fault that changes an output
# failing them.
K5_TOL = {"bf16": {"atol": 6e-3, "rtol": 1e-2},
          "int8": {"atol": 2e-3, "rtol": 1e-2}}

# K4's bf16 body (q bf16; bf16 pools, or int8 codes with their scales;
# the key walk split across a cluster) is held to its own gate the same
# way, against the fp32 plain version on clean, poisoned and
# NaN-poisoned pools: one rounding of the output to bf16 (rtol), and P
# rounded to bf16 (fp16 over int8 pools) before P.V (atol). The splits'
# and warps' partials are merged in fp32. Over every bf16 K4 case of
# this script on an H100 the sound body's worst errors are 1.96e-3 +
# 1e-2 |plain| over bf16 pools and 4.13e-4 + 1e-2 |plain| over int8
# pools (k4_fault_check.py, PERF.md); the limits sit 3.1x and 3.6x above
# them, and that script shows each planted fault that changes an output
# failing them.
K4_TOL = {"bf16": {"atol": 6e-3, "rtol": 1e-2},
          "int8": {"atol": 1.5e-3, "rtol": 1e-2}}

# K2 is held to the shared gate against its plain version in fp32
# (layer_norm_ref): y within ATOL, mean and rstd within 2e-5. At a large
# mean (1e3 + 2 randn) the plain version in fp32 is itself off, since it
# rounds its mean once more, which moves every y by up to ~1e-4; there
# ATOL holds y against the plain formula evaluated in fp64. On top of it
# K2 is held to its own gate, element by element, |out - exact| <= atol
# + rtol |exact|, for y (in x's dtype), mean and rstd (fp32), against
# the plain formula in fp64, in every case. fp32 y differs by a few
# fp32 roundings and rsqrtf's error (rtol), bf16 y by its one rounding to
# bf16 (rtol 2**-8); the mean by one fp32 rounding of a value up to 1e3
# (rtol), rstd by rsqrtf's. Over the K2 cases of this script at C <= 771
# on an H100 the sound kernels' worst errors are fp32 y 7.5e-8 + 1e-6
# |exact|, bf16 y 5.7e-8 + 2**-8 |exact| (half a bf16 ulp), mean 9.2e-8
# + 1.2e-7 |exact|, rstd 3.4e-8 + 1e-7 |exact| (k2_fault_check.py,
# PERF.md): the limits sit 3-4x above them. The wide bf16 rows (C 2048,
# 65536) reach 0.43 and 0.52 of the limits, their means' fp32 sums
# erring by up to 1.5e-7 + 1.2e-7 |exact|. k2_fault_check.py shows each
# planted fault that changes an output failing them.
K2_TOL = {"float32": {"atol": 3e-7, "rtol": 4e-6},
          "bfloat16": {"atol": 2e-7, "rtol": 1.2e-2},
          "mean": {"atol": 4e-7, "rtol": 4.8e-7},
          "rstd": {"atol": 1.4e-7, "rtol": 4e-7}}

# The fp32 paged body (K4 and K5 with fp32 q, over fp32 pools or int8
# codes with their scales; its key walk split across a cluster) is held
# to its own gate on top of ATOL, element by element against the fp32
# plain version on clean, poisoned and NaN-poisoned pools: the two differ
# in summation order only (the online softmax over split key tiles, exp2
# of log2-scaled logits, the merge in fp32). Over every fp32 K4 and K5
# case of this script on an H100 the sound body's worst errors are 4.9e-7
# + 1e-5 |plain| over fp32 pools and 5.4e-6 + 1e-5 |plain| over int8
# pools, whose values reach the blocks' absmax (k45_f32_fault_check.py,
# PERF.md); the limits sit 3.7-4x above them, and that script shows each
# planted fault that changes an output failing them.
F32_PAGED_TOL = {"fp32": {"atol": 2e-6, "rtol": 4e-5},
                 "int8": {"atol": 2e-5, "rtol": 4e-5}}


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
    blocks in the launch until the device drains the queue. Each
    measurement starts from the shortest spin and lengthens it only for
    itself, so the retries of a call with many launches do not add up
    over a run of measurements."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        self.cycles = 20_000_000

    def __call__(self, fn, n: int = 50) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        cycles = self.cycles
        while True:
            ev = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(n)]
            torch.cuda._sleep(cycles)
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
            cycles *= 4
            n = max(10, n // 2)
            check(cycles < 8_000_000_000,
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


_PTXAS_F32 = re.compile(r"paged_f32_kernelI(f|a)Li(\d+)ELi(\d+)E")
_PTXAS_K5 = re.compile(r"chunk_prefill_mma_kernelILi(\d+)E(13__nv_bfloat16|a)E")
_PTXAS_K4 = re.compile(r"paged_decode_mma_kernelILi(\d+)E(13__nv_bfloat16|a)E")
_PTXAS_FLASH = re.compile(r"flash_fwd_(mma_)?kernelI(f)?Li(\d+)E")
_PTXAS_BWD = re.compile(r"flash_(bwd_mma|dq_mma|dkv|dq)_kernelILi(\d+)E"
                        r"(?:Lb(\d)E)?")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def _occupancy(fn, *args) -> str:
    """A tensor-core body's shared memory and the CTAs of it an SM holds
    (for K4's cluster body: the clusters the card holds at once), as the
    CUDA runtime computes them for the built kernel, through the
    occupancy entry point ``fn`` (``ptt_flash_fwd_occupancy``,
    ``ptt_paged_decode_occupancy``, ...)."""
    import ctypes

    from paddle_tpu_torch.ops.kernels import _build

    ctas, smem = ctypes.c_int(), ctypes.c_int()
    err = getattr(_build.load_library(), fn)(*args, ctypes.byref(ctas),
                                             ctypes.byref(smem))
    check(err == 0, f"{fn}{args} failed (cudaError {err})")
    unit = ("clusters on the card" if fn == "ptt_paged_decode_occupancy"
            else "CTAs per SM")
    return (f", {smem.value} bytes shared memory, {ctas.value} {unit} "
            "(CUDA runtime)")


def _ptxas_label(src: str, name):
    """What a matched kernel name is, whether it is a tensor-core body
    that must not spill, and its occupancy query's (function, args)."""
    if src == "flash_fwd.cu":
        bf16 = name.group(1) is not None
        D = int(name.group(3))
        return (f"K1 {'bf16 mma.sync' if bf16 else 'fp32 CUDA cores'}, D "
                f"{D}", bf16, ("ptt_flash_fwd_occupancy", D))
    if src == "flash_bwd.cu":
        kind, D = name.group(1), int(name.group(2))
        fused = name.group(3) == "1"
        if kind == "dq":
            return f"K3b-dq fp32 CUDA cores, D {D}", False, None
        if kind == "dq_mma":
            return (f"K3b-dq bf16 mma.sync, D {D}", True,
                    ("ptt_flash_bwd_dq_occupancy", D))
        what = "K3a" if fused else "K3b-dkv"
        if kind == "dkv":
            return f"{what} fp32 CUDA cores, D {D}", False, None
        return (f"{what} bf16 mma.sync, D {D}", True,
                ("ptt_flash_bwd_occupancy", D, int(fused)))
    if name.re is _PTXAS_K5:
        D, int8 = int(name.group(1)), name.group(2) == "a"
        return (f"K5 bf16 mma.sync, pool {'int8' if int8 else 'bf16'}, D "
                f"{D}", True, ("ptt_chunk_prefill_occupancy", D,
                               2 if int8 else 1))
    if name.re is _PTXAS_K4:
        D, int8 = int(name.group(1)), name.group(2) == "a"
        return (f"K4 bf16 mma.sync, clusters, pool "
                f"{'int8' if int8 else 'bf16'}, D {D}", True,
                ("ptt_paged_decode_occupancy", D, 2 if int8 else 1))
    return (f"K4/K5 fp32 body, pool {'int8' if name.group(1) == 'a' else 'fp32'}"
            f", D {name.group(2)}, {name.group(3)}-row tiles", False, None)


def _sass_ops(obj: str, ops=("HMMA", "RED", "ATOM")):
    """Per kernel of an object file, how many SASS instructions of each
    family of ``ops`` ``cuobjdump -sass`` lists (HMMA: tensor-core
    products; RED, ATOM and their global forms REDG, ATOMG: the fused
    dQ's atomics)."""
    import shutil
    from pathlib import Path

    from paddle_tpu_torch.ops.kernels import _build

    tool = shutil.which("cuobjdump") or str(
        Path(_build._nvcc()).parent / "cuobjdump")
    out = subprocess.run([tool, "-sass", obj], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump -sass {obj}: {out.stderr}")
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = dict.fromkeys(ops, 0)
        elif fn is not None:
            m = re.search(r"\s(" + "|".join(ops) + r")G?[.\s]", line)
            if m:
                counts[fn][m.group(1)] += 1
    return counts


def ptxas_phase():
    """Registers and spills of every K1, K3, K4 and K5 instantiation, from
    ``nvcc -Xptxas -v`` on their sources; a bf16 K1, K3a, K3b-dkv, K3b-dq,
    K4 or K5 (the tensor-core bodies) or an instantiation of the fp32
    paged body that spills fails the run. For the tensor-core bodies also
    their shared memory and the CTAs an SM holds (K4: the clusters the
    card holds), and for the bf16 K3, K4 and K5 bodies the tensor-core
    products (HMMA) and atomics in their SASS: a body without HMMA, a K3a
    without atomics, or a K3b-dq with any, fails; so does an fp32 paged
    body with any HMMA (fp32 stays on the CUDA cores)."""
    import tempfile

    from paddle_tpu_torch.ops.kernels import _build

    pats = {"paged_attention.cu": (_PTXAS_K4, _PTXAS_F32),
            "chunk_prefill.cu": (_PTXAS_K5, _PTXAS_F32),
            "flash_fwd.cu": (_PTXAS_FLASH,), "flash_bwd.cu": (_PTXAS_BWD,)}
    srcs = [p for p in _build.sources() if p.name in pats]
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
             str(src), "-o", f"{tmp}/{src.stem}.o"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src in srcs]
        outs = [p.communicate(timeout=600)[0] for p in procs]
        check(all(p.returncode == 0 for p in procs),
              "nvcc -Xptxas -v failed:\n" + "\n".join(
                  o for p, o in zip(procs, outs) if p.returncode))
        sass = {**_sass_ops(f"{tmp}/flash_bwd.o"),
                **_sass_ops(f"{tmp}/chunk_prefill.o"),
                **_sass_ops(f"{tmp}/paged_attention.o")}
    seen = {"K1": 0, "K3": 0, "K4": 0, "K5": 0, "F32": 0}
    for src, out in zip(srcs, outs):
        name = spill = None
        for line in out.splitlines():
            if "Compiling entry function" in line:
                name = next((m for m in (p.search(line)
                                         for p in pats[src.name]) if m),
                            None)
                full = line.split("'")[1] if "'" in line else ""
            elif name is not None and "spill" in line:
                spill = _SPILL.search(line)
            elif name is not None and "Used" in line:
                label, mma, occ = _ptxas_label(src.name, name)
                regs = int(line.split("Used", 1)[1].split()[0])
                stores, loads = int(spill.group(1)), int(spill.group(2))
                extra = ""
                if name.re is _PTXAS_F32:
                    # fp32 on the CUDA cores: no TF32 or bf16 products
                    ops = sass.get(full)
                    seen["F32"] += 1
                    check(stores == loads == 0, f"ptxas: {label} spills "
                          f"{stores} bytes stored, {loads} loaded")
                    check(ops is not None and ops["HMMA"] == 0,
                          f"SASS: {label} has tensor-core products ({ops})")
                    extra = f", SASS {ops['HMMA']} HMMA"
                if mma:
                    seen[label[:2]] += 1
                    extra = _occupancy(*occ)
                    check(stores == loads == 0, f"ptxas: {label} spills "
                          f"{stores} bytes stored, {loads} loaded")
                if mma and src.name in ("flash_bwd.cu", "chunk_prefill.cu",
                                        "paged_attention.cu"):
                    ops = sass.get(full)
                    check(ops is not None and ops["HMMA"] > 0,
                          f"SASS: {label} has no HMMA ({ops})")
                    check(not label.startswith("K3a")
                          or ops["RED"] + ops["ATOM"] > 0,
                          f"SASS: {label} has no atomics for dQ ({ops})")
                    check(not label.startswith("K3b-dq")
                          or ops["RED"] + ops["ATOM"] == 0,
                          f"SASS: {label} has atomics, but writes dQ "
                          f"once ({ops})")
                    extra += (f", SASS {ops['HMMA']} HMMA, {ops['RED']} "
                              f"RED, {ops['ATOM']} ATOM")
                print(f"ptxas {src.name}: {label}: {regs} registers, "
                      f"{stores} bytes spill stores, {loads} bytes spill "
                      f"loads{extra}", flush=True)
                name = None
    check(seen == {"K1": 2, "K3": 6, "K4": 4, "K5": 4, "F32": 16}, f"ptxas: "
          f"bodies seen {seen}, expected the tensor-core K1 at D 64 and "
          "128, K3a, K3b-dkv and K3b-dq at both, K4 and K5 over bf16 and "
          "int8 pools at both, and the fp32 body over fp32 and int8 pools "
          "at both: K4's 16-row tiles, K5's 16, 32 and 64")


def _bound(nbytes: float, flops: float, dtype: str):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / PEAK_FLOPS[dtype] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _err(out, ref) -> float:
    return float((out.float() - ref.float()).abs().max())


def _record(rows, name, dtype, shape, err, timer, kernel, plain, library,
            nbytes, flops, **extra):
    bound_ms, bound_by = _bound(nbytes, flops, dtype)
    row = {"kernel": name, "dtype": dtype, "shape": shape,
           "max_abs_err": err, "kernel_ms": timer(kernel),
           "plain_ms": timer(plain),
           "library_ms": timer(library), "bound_ms": bound_ms,
           "bound_by": bound_by, **extra}
    rows.append(row)
    print("  " + json.dumps(row), flush=True)


# K2's cases: the timed shapes (R, C), serving's decode step and chunk
# (8 and 128 rows) and training's 16 x 1024 rows, in both dtypes; then
# rows of large mean (1e3 + 2 randn, fp32 only: bf16 keeps 8 bits of
# 1e3), where E[x^2] - mean^2 would lose ~1% of the variance; an odd C
# (771: no whole 16-byte vectors) and an offset view (x one element past
# an aligned base), which take the row kernel; and the wide rows of
# K2_WIDE: C 2048 (bf16: the warp kernel at its cap of 8 vectors a
# lane; fp32: the row kernel staged by 16-byte vectors), 16384 (staged
# past 48 KB of shared memory) and 65536 (fp32: past what one CTA's
# shared memory holds, read from global memory on each pass)
K2_TIMED = ((8, 768), (128, 768), (16384, 768))
K2_WIDE = ((64, 2048), (16, 16384), (4, 65536))


def k2_case_inputs(torch, dtype):
    """Every K2 case at ``dtype``: dicts of x, w, b, the shape label and
    whether it is timed."""
    g = torch.Generator(device="cuda").manual_seed(11)

    def affine(C):
        w = 1 + 0.1 * torch.randn(C, device="cuda", generator=g)
        b = 0.1 * torch.randn(C, device="cuda", generator=g)
        return w.to(dtype), b.to(dtype)

    for R, C in K2_TIMED:
        x = (torch.randn(R, C, device="cuda", generator=g) * 2 + 0.5)
        yield dict(x=x.to(dtype), wb=affine(C), shape=[R, C], timed=True)
    if dtype == torch.float32:
        x = torch.randn(128, 768, device="cuda", generator=g) * 2 + 1e3
        yield dict(x=x, wb=affine(768), shape=["large mean", 128, 768],
                   timed=False, plain_sound=False)
    x = torch.randn(64, 771, device="cuda", generator=g) * 2 + 0.5
    yield dict(x=x.to(dtype), wb=affine(771), shape=["odd C", 64, 771],
               timed=False)
    buf = torch.randn(64 * 768 + 8, device="cuda", generator=g) * 2 + 0.5
    x = buf.to(dtype)[1:64 * 768 + 1].view(64, 768)
    yield dict(x=x, wb=affine(768), shape=["offset view", 64, 768],
               timed=False)
    for R, C in K2_WIDE:
        x = torch.randn(R, C, device="cuda", generator=g) * 2 + 0.5
        yield dict(x=x.to(dtype), wb=affine(C), shape=["wide", R, C],
                   timed=False)


def _ln_exact(torch, x, w, b, eps):
    """The plain version's formula (layer_norm_ref's) in fp64: y, mean,
    rstd."""
    xd = x.double()
    mean = xd.mean(dim=-1, keepdim=True)
    xc = xd - mean
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    y = xc * rstd
    if w is not None:
        y = y * w.double()
    if b is not None:
        y = y + b.double()
    return y, mean, rstd


def k2_run(torch, case):
    """K2 on one case with w and b, w only, b only and neither: the
    kernel's (y, mean, rstd), the plain version's on x, w and b in fp32,
    and the exact ones of each. Before each launch a NaN tensor of y's
    size is freed, so that an output row the kernel leaves unwritten
    reads NaN, not an earlier call's values."""
    from paddle_tpu_torch.ops.kernels import layer_norm as k2

    x, (w, b) = case["x"], case["wb"]
    f32 = (lambda t: None if t is None else t.float())
    outs, plain, exact = [], [], []
    for wi, bi in ((w, b), (w, None), (None, b), (None, None)):
        torch.full_like(x, float("nan"))
        outs.append(k2.layer_norm_fwd(x, wi, bi, 1e-5))
        plain.append(k2.layer_norm_ref(f32(x), f32(wi), f32(bi), 1e-5))
        exact.append(_ln_exact(torch, x, wi, bi, 1e-5))
    torch.cuda.synchronize()
    return outs, plain, exact


def k2_errors(dn, case, outs, plain, exact):
    """K2's measures: for the shared gate, the largest |y - plain| (ATOL;
    against the exact y where the fp32 plain version is not sound, as at
    a large mean) and the largest |mean - plain| and |rstd - plain|
    (2e-5; 0 where the plain version is not sound); and K2's own, the
    largest |out - exact| / (atol + rtol |exact|) of any element of y,
    mean or rstd against ``K2_TOL`` (NaN if any is not finite)."""
    sound = case.get("plain_sound", True)
    err, stat_err, share = 0.0, 0.0, 0.0
    for out, pl, ref in zip(outs, plain, exact):
        if sound:
            err = max(err, _err(out[0], pl[0]))
            stat_err = max(stat_err, _err(out[1], pl[1]),
                           _err(out[2], pl[2]))
        else:
            err = max(err, float((out[0].double() - ref[0]).abs().max()))
        for tol, a, r in ((K2_TOL[dn], out[0], ref[0]),
                          (K2_TOL["mean"], out[1], ref[1]),
                          (K2_TOL["rstd"], out[2], ref[2])):
            ratio = (a.double() - r).abs() / (tol["atol"]
                                              + tol["rtol"] * r.abs())
            if not _finite(ratio):
                return float("nan"), float("nan"), float("nan")
            share = max(share, float(ratio.max()))
    return err, stat_err, share


def layer_norm_phase(torch, timer, rows):
    """K2 on every case, fp32 and bf16, with and without w and b: ATOL
    on y and 2e-5 on mean and rstd against the plain version, K2_TOL on
    y, mean and rstd; the timed shapes beside the plain version and
    F.layer_norm."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.kernels import layer_norm as k2

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for case in k2_case_inputs(torch, dtype):
            shape = case["shape"]
            err, stat_err, share = k2_errors(dn, case, *k2_run(torch, case))
            check(err <= ATOL[dn], f"K2 {dn} {shape}: max |y - plain| {err} "
                  f"> {ATOL[dn]}")
            check(stat_err <= 2e-5, f"K2 {dn} {shape}: mean/rstd disagree "
                  f"with the plain version by {stat_err}")
            check(share <= 1.0, f"K2 {dn} {shape}: an element of y, mean or "
                  f"rstd is off by {share} x its K2_TOL limit")
            if not case["timed"]:
                print(f"  K2 {dn} {shape}: max |y - plain| {err:.3g}, at "
                      f"{share:.3g} of K2_TOL", flush=True)
                continue
            x, (w, b) = case["x"], case["wb"]
            R, C = x.shape
            sz = x.element_size()
            _record(rows, "K2", dn, [R, C], err, timer,
                    lambda: k2.layer_norm_fwd(x, w, b, 1e-5),
                    lambda: k2.layer_norm_ref(x, w, b, 1e-5),
                    lambda: TF.layer_norm(x, (C,), w, b, 1e-5),
                    nbytes=R * C * 2 * sz + 2 * C * sz + 8 * R,
                    flops=8 * R * C, k2_limit_share=share,
                    k2_tol=K2_TOL[dn])


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


def _sdpa_yardstick(torch, q, kp, vp, table_t, table, t, reach):
    """The library call of a K4/K5 row: SDPA over the slots' dense view,
    gathered from full-precision pools beforehand (the gather not timed),
    masked col <= t + i."""
    import torch.nn.functional as TF

    s = q.shape[1]
    nrows = min(int(max(reach)) + 1, table.shape[1] * kp.shape[1])
    kd, vd = _dense_view(torch, kp, vp, table_t, nrows)
    qd = q.transpose(1, 2).contiguous()
    tt = torch.as_tensor(t, device="cuda").reshape(-1, 1, 1, 1)
    mask = (torch.arange(nrows, device="cuda")[None, None, None, :]
            <= tt + torch.arange(s, device="cuda")[None, None, :, None])
    return lambda: TF.scaled_dot_product_attention(qd, kd, vd,
                                                   attn_mask=mask)


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


def _q_bytes(H, D, bs, rows_read, blocks_read, q_rows, sz, table_nbytes):
    """Bytes an int8 case must move: the codes of the rows it reads (1
    byte an element, K and V), one fp32 scale per (block, head) read,
    q in and out at q's size, the table."""
    return (rows_read * H * D * 2 + blocks_read * H * 4 * 2
            + 2 * q_rows * H * D * sz + table_nbytes)


def _paged_cost(H, D, bs, bp, t_np, s, sz, int8, index_nbytes):
    """Bytes and operations a K4/K5 case must move and do: each slot's
    rows up to its last query's position that the table holds, read once
    (K and V; int8 codes with a scale a block), q in and out at its size
    ``sz``, the table and offsets (``index_nbytes``); 4 flops a query
    row, key and element."""
    b = len(t_np)
    keys = np.minimum(t_np + s, bp * bs)         # rows the table can hold
    if int8:
        nbytes = _q_bytes(H, D, bs, int(keys.sum()),
                          int(((keys - 1) // bs + 1).sum()), b * s, sz,
                          index_nbytes)
    else:
        nbytes = (int(keys.sum()) * H * D * 2 * sz + 2 * b * s * H * D * sz
                  + index_nbytes)
    flops = 4 * H * D * sum(min(st + i + 1, k) for st, k in zip(t_np, keys)
                            for i in range(s))
    return nbytes, flops


# K4's cases (b, s, offsets, bp, bs) at gpt2_small's heads: the serving
# decode step (8 slots at shuffled offsets 0-1000, the headline row); a
# lone request at t 1000 (12 CTAs a head-walk without the cluster split,
# 16 key tiles); a speculative verify of 4 drafts (s 5) at the decode
# step's offsets; a slot whose reach runs off a table of 5 blocks (80
# rows, no multiple of a 64-key tile); and a verify of 15 drafts (s 16)
# off a table of 3 blocks of 11 rows (33 rows, one past a warp's 16
# keys), whose last warp slice holds one key and 15 zero-filled ones
# that rows 1-15's positions would admit (with 16-row blocks the table's
# end is always a slice's, and the reach mask has nothing to mask).
K4_CASES = ((8, 1, None, 64, 16), (1, 1, (1000,), 64, 16),
            (8, 5, None, 64, 16), (2, 5, (78, 30), 5, 16),
            (1, 16, (32,), 3, 11))
K4_GEOMETRY = (12, 64)                  # H, D: gpt2_small's


def k4_case_inputs(torch, dtype, int8):
    """Every K4 case of phase 3 at q's ``dtype`` over fp pools (q's dtype)
    or int8 code pools, as dicts like :func:`k5_case_inputs`'. The decode
    step's offsets are ``linspace(0, 1000, b)`` shuffled; its inputs at s
    1 are drawn as they were before the other cases existed (seed 21, 22
    over int8 pools: pools, then offsets, then q)."""
    H, D = K4_GEOMETRY
    for ci, (b, s, starts, bp, bs) in enumerate(K4_CASES):
        rs = np.random.RandomState((22 if int8 else 21) + 100 * ci)
        if int8:
            codes, scales, table_t, table = _pool_case_q(torch, rs, b, bp,
                                                         bs, H, D)
            pools = (codes, scales)
        else:
            kp, vp, table_t, table = _pool_case(torch, rs, b, bp, bs, H, D,
                                                dtype)
            pools = (kp, vp)
        if starts is None:
            t_np = np.linspace(0, 1000, b).round().astype(np.int32)
            rs.shuffle(t_np)
        else:
            t_np = np.asarray(starts, np.int32)
        t = torch.from_numpy(t_np).cuda()
        q = torch.from_numpy(rs.randn(b, s, H, D).astype(np.float32)).to(
            "cuda", dtype)
        nbytes, flops = _paged_cost(H, D, bs, bp, t_np, s, q.element_size(),
                                    int8, table.nbytes + 4 * b)
        shape = [b, s, H, D, bs, bp] if starts is None else \
            [b, s, list(starts), H, D, bs, bp]
        yield dict(q=q, pools=pools, table_t=table_t, table=table, t=t,
                   reach=t_np + s - 1, int8=int8, shape=shape,
                   nbytes=nbytes, flops=flops)


def k4_run(torch, case):
    """K4 on one case, as :func:`k5_run` runs K5."""
    from paddle_tpu_torch.ops.kernels import paged_attention as k4

    return _paged_run(torch, case, k4.paged_attention, k4.paged_attention_ref)


def k4_share(int8, outs, exact) -> float:
    """K4's own measure of bf16 q, against ``K4_TOL``, as :func:`k5_share`
    measures K5 against ``K5_TOL``."""
    return limit_share(K4_TOL["int8" if int8 else "bf16"], outs, exact)


def decode_phase(torch, timer, rows, int8):
    """K4 (``int8``: K4-int8) on every case, fp32 and bf16: the shared
    gate, and K4_TOL for bf16 q, F32_PAGED_TOL for fp32; timed beside its
    plain version and SDPA over the dense view gathered (and dequantized)
    beforehand; then a bf16 q and an fp32 q's K pool its C entry must
    refuse."""
    from paddle_tpu_torch.ops.kernels import paged_attention as k4

    _paged_phase(torch, timer, rows, "K4-int8" if int8 else "K4",
                 k4_case_inputs, k4_run, K4_TOL, "k4", int8,
                 k4.paged_attention, k4.paged_attention_ref)
    if not int8:
        for dtype in (torch.bfloat16, torch.float32):
            _refuses_misaligned(torch, "K4", k4, k4.paged_attention,
                                next(k4_case_inputs(torch, dtype, False)))


# K5's cases (s, start): a prompt's first chunk, its second, a chunk over
# the serving path's deepest prefix, a chunk length of no power of two,
# and a chunk whose pad tail runs past the table's end; the int8 pools at
# the first, the deepest and the chunk of no power of two. Both pools also: a chunk running off a
# table of 5 blocks (80 rows, no multiple of a 64-key tile), whose last
# key tile holds 48 zero-filled rows past the reach that its 24 pad
# rows' positions would admit (unmasked, they would take a tenth or more
# of those rows' softmax); and for bf16 q three slots at their own
# starts (the kernel takes a start per slot).
K5_SHAPES = ((128, 0), (128, 128), (128, 517), (100, 300), (64, 1000))
K5_Q_SHAPES = ((128, 0), (128, 517), (100, 300))
K5_OFF_TABLE = (64, 40, 5)              # s, start, bp
K5_SLOTS = (128, (0, 517, 260))
K5_GEOMETRY = (12, 64, 16, 64)          # H, D, bs, bp: gpt2_small's


def k5_case_inputs(torch, dtype, int8, shapes=None):
    """Every K5 case of phase 3 at q's ``dtype`` (or the single-slot
    (s, start) ``shapes``), over fp pools (q's dtype) or int8 code pools:
    dicts of the inputs, the shape label and the bytes and operations a
    case must move and do."""
    H, D, bs, bp0 = K5_GEOMETRY
    if shapes is not None:
        cases = [(1, s, (start,), bp0) for s, start in shapes]
    else:
        cases = [(1, s, (start,), bp0) for s, start in
                 (K5_Q_SHAPES if int8 else K5_SHAPES)]
        cases.append((1, K5_OFF_TABLE[0], (K5_OFF_TABLE[1],),
                      K5_OFF_TABLE[2]))
        if dtype == torch.bfloat16:
            cases.append((len(K5_SLOTS[1]), K5_SLOTS[0], K5_SLOTS[1], bp0))
    for b, s, starts, bp in cases:
        rs = np.random.RandomState((32 if int8 else 31) + starts[0] + s
                                   + 1000 * (b - 1))
        if int8:
            codes, scales, table_t, table = _pool_case_q(torch, rs, b, bp,
                                                         bs, H, D)
            pools = (codes, scales)
        else:
            kp, vp, table_t, table = _pool_case(torch, rs, b, bp, bs, H, D,
                                                dtype)
            pools = (kp, vp)
        q = torch.from_numpy(rs.randn(b, s, H, D).astype(np.float32)).to(
            "cuda", dtype)
        t_np = np.asarray(starts, np.int32)
        t = (torch.tensor(starts[0], dtype=torch.int32, device="cuda")
             if b == 1 else torch.from_numpy(t_np).cuda())
        nbytes, flops = _paged_cost(H, D, bs, bp, t_np, s, q.element_size(),
                                    int8,
                                    table.nbytes + (4 * b if b > 1 else 0))
        shape = [s, starts[0], H, D, bs, bp] if b == 1 else \
            [b, s, list(starts), H, D, bs, bp]
        yield dict(q=q, pools=pools, table_t=table_t, table=table, t=t,
                   reach=t_np + s - 1, int8=int8, shape=shape,
                   nbytes=nbytes, flops=flops)


def k5_run(torch, case):
    """K5 on one case (:func:`_paged_run`)."""
    from paddle_tpu_torch.ops.kernels import chunk_prefill as k5

    return _paged_run(torch, case, k5.chunk_prefill, k5.chunk_prefill_ref)


def _paged_run(torch, case, kernel_fn, ref_fn):
    """K4 or K5 (``kernel_fn``, its plain version ``ref_fn``) on one case:
    the kernel's outputs on clean pools, on pools poisoned where no query
    may read (1e9 rows or saturated codes, 1e7 scales in blocks no table
    names) and on pools with NaN there; the plain version in q's dtype
    (the shared gate's, the reference's order: int8 codes dequantized to
    q's dtype) and in fp32 (the own gates'), clean and poisoned."""
    q, table_t, t = case["q"], case["table_t"], case["t"]

    def kern(a, b, sc=(None, None)):
        return kernel_fn(q, a, b, table_t, t, k_scale=sc[0], v_scale=sc[1])

    def plain(qq, a, b, sc=(None, None)):
        return ref_fn(qq, a, b, table_t, t, k_scale=sc[0], v_scale=sc[1])

    if case["int8"]:
        codes, scales = case["pools"]
        pc, px = _poison_q(torch, codes, scales, case["table"], case["reach"])
        nc, nx = _poison_q(torch, codes, scales, case["table"], case["reach"],
                           dead_scale=float("nan"))
        outs = (kern(*codes, scales), kern(*pc, px), kern(*nc, nx))
        shared = (plain(q, *codes, scales), plain(q, *pc, px))
        exact = (plain(q.float(), *codes, scales), plain(q.float(), *pc, px))
    else:
        kp, vp = case["pools"]
        kpp, vpp = _poison(torch, kp, vp, case["table"], case["reach"])
        kpn, vpn = _poison(torch, kp, vp, case["table"], case["reach"],
                           dead=float("nan"))
        outs = (kern(kp, vp), kern(kpp, vpp), kern(kpn, vpn))
        exact = (plain(q.float(), kp.float(), vp.float()),
                 plain(q.float(), kpp.float(), vpp.float()))
        shared = exact
    torch.cuda.synchronize()
    return outs, shared, exact


def paged_shared_error(dn, int8, outs, shared):
    """The gate every K4/K5 case is held to: the largest |kernel - plain|
    over clean, poisoned, poisoned against clean and NaN-poisoned against
    clean, relative to max(1, max |plain|) for bf16 q over int8 pools
    (whose plain version rounds the dequantized view to bf16), else
    absolute."""
    out, out_p, out_n = outs
    ref, ref_p = shared
    err = max(_err(out, ref), _err(out_p, ref_p), _err(out_p, out),
              _err(out_n, out))
    norm = max(1.0, float(ref.float().abs().max())) \
        if int8 and dn == "bfloat16" else 1.0
    return err, err / norm


def f32_share(int8, outs, exact) -> float:
    """The fp32 body's own measure (fp32 q, K4 or K5), against
    ``F32_PAGED_TOL``."""
    return limit_share(F32_PAGED_TOL["int8" if int8 else "fp32"], outs,
                       exact)


def k5_share(int8, outs, exact) -> float:
    """K5's own measure of bf16 q (:func:`limit_share` of ``K5_TOL``)."""
    return limit_share(K5_TOL["int8" if int8 else "bf16"], outs, exact)


def limit_share(tol, outs, exact) -> float:
    """A redesigned body's own measure: the largest |out - plain| / (atol
    + rtol |plain|) of any element, against the fp32 plain version, over
    clean, poisoned and NaN-poisoned pools (NaN if any is not finite)."""
    worst = 0.0
    for out, ref in zip(outs, (exact[0], exact[1], exact[0])):
        ref = ref.float()
        ratio = (out.float() - ref).abs() / (tol["atol"]
                                             + tol["rtol"] * ref.abs())
        if not _finite(ratio):
            return float("nan")
        worst = max(worst, float(ratio.max()))
    return worst


def _finite(x) -> bool:
    return bool(x.isfinite().all())


def chunk_phase(torch, timer, rows, int8):
    """K5 (``int8``: K5-int8) on every case, fp32 and bf16: the shared
    gate, and K5_TOL for bf16 q, F32_PAGED_TOL for fp32; timed beside its
    plain version and SDPA over the dense view gathered (and dequantized)
    beforehand; then a bf16 q and an fp32 q's K pool its C entry must
    refuse."""
    from paddle_tpu_torch.ops.kernels import chunk_prefill as k5

    _paged_phase(torch, timer, rows, "K5-int8" if int8 else "K5",
                 k5_case_inputs, k5_run, K5_TOL, "k5", int8,
                 k5.chunk_prefill, k5.chunk_prefill_ref)
    if not int8:
        for dtype in (torch.bfloat16, torch.float32):
            _refuses_misaligned(torch, "K5", k5, k5.chunk_prefill,
                                next(k5_case_inputs(torch, dtype, False)))


def _paged_phase(torch, timer, rows, name, cases, run, tols, kid, int8,
                 kernel_fn, ref_fn):
    """Every case of ``cases`` (K4's or K5's generator), fp32 and bf16 q:
    ``run`` on it, the shared gate, the body's own gate (:func:`limit_share`
    against ``tols`` for bf16 q, reported as ``<kid>_limit_share``, and
    against F32_PAGED_TOL for fp32 q, as ``f32_limit_share``), and the row
    timed beside its plain version and SDPA over the dense view gathered
    (and dequantized) beforehand."""
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for case in cases(torch, dtype, int8):
            shape = case["shape"]
            outs, shared, exact = run(torch, case)
            check(all(_finite(o) for o in outs),
                  f"{name} {dn} {shape}: non-finite output on a poisoned "
                  "pool")
            err, rel = paged_shared_error(dn, int8, outs, shared)
            check(rel <= ATOL[dn], f"{name} {dn} {shape}: max |kernel - "
                  f"plain| {err} (relative {rel}) > {ATOL[dn]} (clean, "
                  "poisoned, or poisoned vs clean)")
            if dn == "bfloat16":
                tol, gate = tols["int8" if int8 else "bf16"], kid
            else:
                tol, gate = F32_PAGED_TOL["int8" if int8 else "fp32"], "f32"
            share = limit_share(tol, outs, exact)
            check(share <= 1.0, f"{name} {dn} {shape}: an element is off by "
                  f"{share} x (atol {tol['atol']} + rtol {tol['rtol']} "
                  "|plain|)")
            extra = {f"{gate}_limit_share": share, f"{gate}_tol": tol}
            q, table_t, t = case["q"], case["table_t"], case["t"]
            if int8:    # the library's view is dequantized beforehand
                (kc, vc), sc = case["pools"]
                kd, vd = ((c.float() * x[:, None, :, None]).to(q.dtype)
                          for c, x in zip((kc, vc), sc))
            else:
                (kc, vc), sc = case["pools"], (None, None)
                kd, vd = kc, vc
            _record(rows, name, dn, shape, err, timer,
                    lambda: kernel_fn(q, kc, vc, table_t, t, k_scale=sc[0],
                                      v_scale=sc[1]),
                    lambda: ref_fn(q, kc, vc, table_t, t, k_scale=sc[0],
                                   v_scale=sc[1]),
                    _sdpa_yardstick(torch, q, kd, vd, table_t, case["table"],
                                    t, case["reach"]),
                    nbytes=case["nbytes"], flops=case["flops"], **extra)


def _misaligned(torch, x):
    """A contiguous copy of ``x`` one element past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 8, dtype=x.dtype, device="cuda")
    xm = buf[1:x.numel() + 1].view(x.shape)
    xm.copy_(x)
    check(xm.is_contiguous() and xm.data_ptr() % 16 != 0,
          "the misaligned case is not misaligned")
    return xm


def _refuses_misaligned(torch, name, mod, kernel_fn, case):
    """A bf16 q one element past a 16-byte boundary reaches the C entry,
    which must refuse it (cudaErrorInvalidValue = 1): cp.async takes
    16-byte chunks; so must an fp32 q's K pool (the fp32 body stages K and
    V by cp.async too). Nothing is launched or counted."""
    q, (kp, vp) = case["q"], case["pools"]
    what = "q" if q.dtype == torch.bfloat16 else "k_pool"
    if what == "q":
        q = _misaligned(torch, q)
    else:
        kp = _misaligned(torch, kp)
    dn = str(q.dtype).split(".")[1]
    before = mod.launches
    try:
        kernel_fn(q, kp, vp, case["table_t"], case["t"])
    except RuntimeError as e:
        check("CUDA error 1 " in str(e), f"{name} misaligned {what}: {e}")
    else:
        fail(f"{name} launched on a {dn} {what} misaligned for cp.async")
    check(mod.launches == before, f"{name} counted a refused launch")
    print(f"  {name} {dn}: a {what} misaligned by one element is refused by "
          "the C entry", flush=True)


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
    record one row each; ``errs`` maps kernel id to its checked error
    (for the K3 kernels also the largest share of K3_TOL). The K3 rows'
    library call is SDPA's backward alone (its forward run once outside
    the events), with its forward + backward beside it."""
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

    out_l = TF.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
    plain_bwd = timer(lambda: fa.flash_bwd_ref(*bwd), n=10)
    library_bwd = timer(lambda: torch.autograd.grad(
        out_l, (ql, kl, vl), dot, retain_graph=True), n=10)
    library_both = timer(library_fwd_bwd, n=10)
    del out_l
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
        else:
            row["library_fwd_bwd_ms"] = library_both
        if kid != "K1":
            row.update(k3_limit_share=errs[kid][2], k3_tol=K3_TOL[dn])
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


# the backward's outputs by name: a K3 kernel's gradients and the plain
# ones are dicts over (some of) these
GRADS = ("dQ", "dK", "dV")


def _grads(prefix, got, want):
    """(kernel, plain) pairs for :func:`_flash_check`, by output name."""
    return {f"{prefix}{n}": (a, want[n]) for n, a in got.items()}


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


def k3_errors(dn, got, want):
    """K3's own measure against the plain version: per output of ``got``
    (name -> gradient, whichever of GRADS the kernel computes; ``want``
    holds the plain three), the largest |out - plain| / (atol + rtol *
    |plain|) of any element (NaN if any element is not finite)."""
    tol = K3_TOL[dn]
    out = {}
    for name, a in got.items():
        b = want[name].float()
        ratio = (a.float() - b).abs() / (tol["atol"][name]
                                         + tol["rtol"] * b.abs())
        out[name] = float(ratio.max())
    return out


def k3_passes(dn, got, want) -> bool:
    return all(r <= 1.0 for r in k3_errors(dn, got, want).values())


def _k3_check(torch, dn, shape, kid, got, want):
    """FLASH_TOL on each gradient, then K3's own limits; returns (max
    |err|, relative err, the largest share of K3_TOL)."""
    worst = _flash_check(torch, dn, shape, _grads(f"{kid} ", got, want))
    shares = k3_errors(dn, got, want)
    for name, r in shares.items():
        check(r <= 1.0, f"{kid} {dn} {shape}: an element of {name} is off "
              f"by {r} x (atol {K3_TOL[dn]['atol'][name]} + rtol "
              f"{K3_TOL[dn]['rtol']} |plain|)")
    return worst + (max(shares.values()),)


def k3_grads(torch, q, k, v, do, causal):
    """The plain gradients and each K3 kernel's (K3a's dQ, dK, dV,
    K3b-dkv's dK, dV, K3b-dq's dQ; dicts by name) computed, as in
    training, from K1's lse (delta from the plain O), and the kernels'
    arguments."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    scale = 1.0 / q.shape[-1] ** 0.5
    lse = fa.flash_fwd(q, k, v, scale, causal)[1]
    ro, rlse = fa.flash_fwd_ref(q, k, v, scale, causal)
    delta = (do.float() * ro.float()).sum(-1).transpose(1, 2).contiguous()
    want = dict(zip(GRADS, fa.flash_bwd_ref(q, k, v, do, rlse, delta, scale,
                                            causal)))
    bwd = (q, k, v, do, lse, delta, scale, causal)
    return want, {"K3a": dict(zip(GRADS, fa.flash_bwd_fused(*bwd))),
                  "K3b-dkv": dict(zip(GRADS[1:], fa.flash_bwd_dkv(*bwd))),
                  "K3b-dq": {"dQ": fa.flash_bwd_dq(*bwd)}}, bwd


def k3_case_inputs(torch, dtype):
    """(name, (q, k, v, dO), causal) of every K3 case beyond the timed
    shapes: the K1 cases of :func:`k1_case_inputs`, each with a dO of q's
    layout (for the NaN-past-S cases a view of a NaN-padded buffer too)."""
    g = torch.Generator(device="cuda").manual_seed(59)
    for name, qkv, causal, _ in k1_case_inputs(torch, dtype):
        q = qkv[0]
        do = torch.randn(q.shape, device="cuda", generator=g).to(dtype)
        if name.startswith("NaN past S"):
            buf = torch.full((q.shape[0], q.shape[1] + 64, *q.shape[2:]),
                             float("nan"), device="cuda", dtype=dtype)
            buf[:, :q.shape[1]] = do
            do = buf[:, :q.shape[1]]
        yield name, (*qkv, do), causal


def k3_cases(torch, dtype):
    """Every case of :func:`k3_case_inputs` through K3a, K3b-dkv and
    K3b-dq against the plain version, both gates; then misaligned
    pointers handed to their C entry points, which must refuse them for
    bf16."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    dn = str(dtype).split(".")[1]
    for name, (q, k, v, do), causal in k3_case_inputs(torch, dtype):
        want, got, _ = k3_grads(torch, q, k, v, do, causal)
        torch.cuda.synchronize()
        for kid, grads in got.items():
            err = _k3_check(torch, dn, name, kid, grads, want)
            print(f"  {kid} {dn} {name}: max |err| {err[0]:.3g}, relative "
                  f"{err[1]:.3g}, at {err[2]:.3g} of K3_TOL", flush=True)
    if dtype != torch.bfloat16:
        return
    lib = _build.load_library()
    q = torch.zeros(1, 128, 1, 64, device="cuda", dtype=dtype)
    vec = torch.zeros(1, 1, 128, device="cuda")
    acc = torch.zeros(1, 128, 1, 64, device="cuda")
    grads = [torch.empty_like(q) for _ in range(2)]
    p = [t.data_ptr() for t in (q, q, q, q, vec, vec)]
    tail = fa._tail(q, q, 0.125, True)
    for bad in (0, 3):    # q, then dO, 2 bytes past a 16-byte boundary
        args = list(p)
        args[bad] += 2
        errs = (lib.ptt_flash_bwd_fused(*args, acc.data_ptr(),
                                        *[t.data_ptr() for t in grads],
                                        *tail),
                lib.ptt_flash_bwd_dkv(*args, *[t.data_ptr() for t in grads],
                                      *tail),
                lib.ptt_flash_bwd_dq(*args, grads[0].data_ptr(), *tail))
        check(errs == (1, 1, 1), f"K3 bf16 took a misaligned "
              f"{'q' if bad == 0 else 'dO'} pointer (returned {errs})")
    print("  K3a, K3b-dkv, K3b-dq bf16 misaligned q or dO pointer: refused "
          "at the entry points (cudaError 1)", flush=True)


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
            got = fa.kernel_layout(*qkv)
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
        k3_cases(torch, dtype)
        for ci, (B, S, H, D, causal) in enumerate(FLASH_CASES):
            shape = [B, S, H, D, causal]
            q, k, v, do = _flash_inputs(torch, B, S, H, D, dtype, 41 + ci)
            scale = 1.0 / D ** 0.5
            o, lse = fa.flash_fwd(q, k, v, scale, causal)
            ro, rlse = fa.flash_fwd_ref(q, k, v, scale, causal)
            delta = (do.float() * ro.float()).sum(-1).transpose(
                1, 2).contiguous()
            want = dict(zip(GRADS, fa.flash_bwd_ref(q, k, v, do, rlse, delta,
                                                    scale, causal)))
            # the backward kernels recompute P from K1's lse, as in training
            bwd = (q, k, v, do, lse, delta, scale, causal)
            fused = dict(zip(GRADS, fa.flash_bwd_fused(*bwd)))
            split = dict(zip(GRADS, (fa.flash_bwd_dq(*bwd),
                                     *fa.flash_bwd_dkv(*bwd))))
            torch.cuda.synchronize()
            e_fwd = _k1_check(torch, dn, shape, o, ro, lse, rlse)
            e_fused = _k3_check(torch, dn, shape, "K3a", fused, want)
            e_dkv = _k3_check(torch, dn, shape, "K3b-dkv",
                              {n: split[n] for n in GRADS[1:]}, want)
            e_dq = _k3_check(torch, dn, shape, "K3b-dq", {"dQ": split["dQ"]},
                             want)
            _flash_check(torch, dn, shape, _grads("split ", split, want))
            errs = {"K1": e_fwd, "K3a": e_fused, "K3b-dkv": e_dkv,
                    "K3b-dq": e_dq}
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
        want = dict(zip(GRADS, fa.flash_bwd_ref(q, k, v, do, rlse, delta,
                                                scale, causal)))
        # lse from the same kernel on the same inputs, outside the count
        lse = fa.flash_fwd(q, k, v, scale, causal)[1]
        e_fwd = _k1_check(torch, dn, shape, out.detach(), ro, lse, rlse)
        _flash_check(torch, dn, shape, _grads("split ", dict(zip(
            GRADS, (ql.grad, kl.grad, vl.grad))), want))
        e_dkv = _k3_check(torch, dn, shape, "K3b-dkv",
                          {"dK": kl.grad, "dV": vl.grad}, want)
        e_dq = _k3_check(torch, dn, shape, "K3b-dq", {"dQ": ql.grad}, want)
        fused = dict(zip(GRADS, fa.flash_bwd_fused(q, k, v, do, lse, delta,
                                                   scale, causal)))
        torch.cuda.synchronize()
        e_fused = _k3_check(torch, dn, shape, "K3a", fused, want)
        _flash_rows(torch, timer, rows, dn, shape, q, k, v, do, scale, causal,
                    {"K1": e_fwd, "K3a": e_fused, "K3b-dkv": e_dkv,
                     "K3b-dq": e_dq})
    return long_launches


def _serving_trace(vocab):
    """Phase 5's 16 requests from ``RandomState(0)``: prompts of 24-700
    tokens, 32-64 new, 12 greedy and 4 at temperature 0.8 / top-p 0.9.
    Returned as Request keyword dicts."""
    rs = np.random.RandomState(0)
    sampled = set(rs.choice(16, 4, replace=False).tolist())
    out = []
    for i in range(16):
        plen = int(rs.randint(24, 701))
        n = int(rs.randint(32, 65))
        prompt = rs.randint(0, vocab, plen).tolist()
        kw = (dict(temperature=0.8, top_p=0.9) if i in sampled
              else dict(greedy=True))
        out.append(dict(prompt=prompt, max_new_tokens=n, **kw))
    return out


def _serve(torch, model, trace, **engine_kw):
    """One run of ``trace`` through ``ServingEngine(model, 8 slots, max_len
    1024, blocks of 16, chunks of 128, **engine_kw)`` on the card, after a
    warm-up request (cuBLAS handles, the allocator) outside the counted
    run: the engine, the requests, their streams, the aggregate, the wall
    seconds and the launch counts of the run (every counter set to 0 just
    before it)."""
    from paddle_tpu_torch.inference import Request, ServingEngine
    from paddle_tpu_torch.ops.kernels import chunk_prefill as k5
    from paddle_tpu_torch.ops.kernels import layer_norm as k2
    from paddle_tpu_torch.ops.kernels import paged_attention as k4

    eng = ServingEngine(model, max_batch_slots=8, max_len=1024,
                        block_size=16, prefill_chunk=128, seed=0,
                        device="cuda", **engine_kw)
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
    for r in reqs:
        check(r.status == "done" and r.finish_reason in ("length", "eos"),
              f"request {r.id} ended {r.status}/{r.finish_reason}")
        check([tk for tk, _ in streamed[r.id]] == r.tokens
              and streamed[r.id][-1][1],
              f"request {r.id}: the stream differs from its tokens")
    return eng, reqs, agg, wall, launches


def _check_launches(what, launches, L, chunks, steps, int8):
    """The kernels' counters against the engine's own chunk and step
    counts: K2 twice a layer and once at the end of every forward, K4 a
    layer a decode step, K5 a layer a prefill chunk (int8 pools: their
    int8 counters, the fp ones 0)."""
    q = "-int8" if int8 else ""
    want = {"K2": (2 * L + 1) * (chunks + steps), "K4": 0, "K5": 0,
            "K4-int8": 0, "K5-int8": 0}
    want.update({f"K4{q}": L * steps, f"K5{q}": L * chunks})
    check(launches == want, f"{what}: launch counts {launches} != {want} "
          f"implied by {chunks} chunks and {steps} steps")


def _agreement(torch, model, reqs):
    """Greedy tokens equal to the argmax of a teacher-forced no-cache
    forward of prompt + tokens[:-1]: (agreeing, checked)."""
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
    return agree, total


def _perf_line(what, card, agg, wall):
    return (f"{what} perf on {card}: {agg['aggregate_tokens_per_s']:.1f} "
            f"tokens/s, TTFT p50 {agg['ttft_p50_s'] * 1e3:.1f} ms, decode "
            f"step p50 {agg['decode_step_ms_p50']:.2f} ms, wall {wall:.2f} s, "
            f"kv_bytes_in_use_peak {int(agg['kv_bytes_in_use_peak'])}")


def serving_phase(torch, card):
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_small

    # fp32 end to end (no TF32, set in main): the greedy check below
    # compares two fp32 computations of the same logits
    cfg = gpt2_small()
    # GPT's initialisers from a seeded generator: normal(0, 0.02), the
    # residual output projections scaled by 1/sqrt(2 * layers)
    model = GPTForCausalLM(cfg, device="cuda", seed=0)
    model.eval()
    _, reqs, agg, wall, launches = _serve(torch, model,
                                          _serving_trace(cfg.vocab_size))
    chunks, steps = int(agg["prefill_chunks"]), int(agg["decode_steps"])
    print(f"serving: {int(agg['completed'])} requests, {chunks} prefill "
          f"chunks, {steps} decode steps, {int(agg['preemptions'])} "
          f"preemptions, blocks peak {int(agg['blocks_in_use_peak'])}, "
          f"launches {launches}", flush=True)
    _check_launches("fp32 serving", launches, cfg.num_layers, chunks, steps,
                    int8=False)

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
    print(_perf_line("serving", card, agg, wall), flush=True)
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


def serving_q_phase(torch, card, model, fp_agg):
    """Phase 5b: int8 pools and the prefix cache on the same model;
    returns the int8 kernels' launch counts."""
    from paddle_tpu_torch.inference import PrefixCache

    cfg = model.config
    trace = _shared_prefix_trace(cfg.vocab_size)
    cache = PrefixCache(chunk_tokens=128, max_bytes=1 << 30)
    eng, reqs, agg, wall, launches = _serve(torch, model, trace,
                                            kv_dtype="int8",
                                            prefix_cache=cache)
    # the warm-up prompt is shorter than a chunk: it cached nothing and
    # hit nothing, so the trie's counter is the run's
    chunks, steps = int(agg["prefill_chunks"]), int(agg["decode_steps"])
    hits = int(agg["prefix_hit_tokens"])
    print(f"int8 + prefix cache: {int(agg['completed'])} requests, {chunks} "
          f"prefill chunks, {steps} decode steps, "
          f"{int(agg['preemptions'])} preemptions, prefix hit tokens "
          f"{hits} (rate {agg['prefix_hit_rate']:.3f}), evictions "
          f"{int(agg['evictions'])}, launches {launches}", flush=True)
    _check_launches("int8 serving", launches, cfg.num_layers, chunks, steps,
                    int8=True)
    check(hits > 0 and hits == cache.hit_tokens,
          f"prefix hit tokens {hits}, the trie's {cache.hit_tokens}")
    held = {b for n in cache.iter_nodes() for b in n.blocks}
    check(eng._alloc.blocks_in_use() == len(held),
          f"{eng._alloc.blocks_in_use()} blocks in use after the run, the "
          f"trie holds {len(held)}")

    # the same trace with the cache off, on int8 pools: token-exact for
    # the greedy requests (chunk_tokens == prefill_chunk, so a spliced
    # prefix holds the codes a cold prefill commits)
    _, cold, cold_agg, _, _ = _serve(torch, model, trace, kv_dtype="int8")
    for r, c in zip(reqs, cold):
        if r.greedy:
            check(r.tokens == c.tokens, f"int8 request {r.id}: cache on "
                  f"{r.tokens[:8]}... != cache off {c.tokens[:8]}...")
    print(f"cache on vs off (int8): greedy tokens equal; prefill chunks "
          f"{chunks} vs {int(cold_agg['prefill_chunks'])}", flush=True)

    # agreement with the fp32 teacher-forced no-cache argmax; the limit
    # is the reference's int8 contract (test_paged_kv.py:502)
    agree, total = _agreement(torch, model, reqs)
    rate = agree / total
    print(f"int8 greedy agreement with the fp32 argmax: {agree}/{total} = "
          f"{rate:.4f} (limit 0.9)", flush=True)
    check(rate >= 0.9, f"int8 greedy agreement {rate} < 0.9")
    print(_perf_line("int8 serving", card, agg, wall) + f" (phase 5, fp32: "
          f"{int(fp_agg['kv_bytes_in_use_peak'])}); cache off: "
          f"{cold_agg['aggregate_tokens_per_s']:.1f} tokens/s, TTFT p50 "
          f"{cold_agg['ttft_p50_s'] * 1e3:.1f} ms, kv_bytes_in_use_peak "
          f"{int(cold_agg['kv_bytes_in_use_peak'])}", flush=True)
    return launches


def serving_bf16_phase(torch, card):
    """Phase 5c: ``gpt2_small`` in bf16 at full width and depth, whose
    chunk prefill launches K5's and whose decode steps launch K4's
    tensor-core body, serves phase 5's first 8
    greedy requests on bf16 pools, then on int8 pools: exact launch
    counts, every request done, and greedy agreement with the bf16
    teacher-forced argmax >= 0.9 (5b's limit, test_paged_kv.py:502).
    Returns the launch counts of the bf16-pool and the int8-pool run."""
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_small

    cfg = gpt2_small()
    model = GPTForCausalLM(cfg, device="cuda", seed=0, dtype=torch.bfloat16)
    model.eval()
    trace = [kw for kw in _serving_trace(cfg.vocab_size)
             if kw.get("greedy")][:8]
    out = {}
    for kv in (None, "int8"):
        what = f"bf16 serving{', int8 pools' if kv else ''}"
        _, reqs, agg, wall, launches = _serve(torch, model, trace,
                                              kv_dtype=kv)
        chunks, steps = int(agg["prefill_chunks"]), int(agg["decode_steps"])
        print(f"{what}: {int(agg['completed'])} requests, {chunks} prefill "
              f"chunks, {steps} decode steps, launches {launches}",
              flush=True)
        _check_launches(what, launches, cfg.num_layers, chunks, steps,
                        int8=kv is not None)
        agree, total = _agreement(torch, model, reqs)
        rate = agree / total
        print(f"{what}: greedy agreement with the bf16 argmax {agree}/"
              f"{total} = {rate:.4f} (limit 0.9)", flush=True)
        check(rate >= 0.9, f"{what}: greedy agreement {rate} < 0.9")
        print(_perf_line(what, card, agg, wall), flush=True)
        out[kv] = launches
    return out[None], out["int8"]


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
    "K5-bf16": ("chunk_prefill (bf16 mma.sync body)",
                "paddle_tpu_torch/csrc/chunk_prefill.cu",
                "paddle_tpu/ops/pallas/chunk_prefill.py:93"),
    "K5-int8-bf16": ("chunk_prefill (bf16 mma.sync body, int8 pools)",
                     "paddle_tpu_torch/csrc/chunk_prefill.cu",
                     "paddle_tpu/ops/pallas/chunk_prefill.py:126"),
    "K4-bf16": ("paged_attention (bf16 mma.sync cluster body)",
                "paddle_tpu_torch/csrc/paged_attention.cu",
                "paddle_tpu/ops/pallas/paged_attention.py:103"),
    "K4-int8-bf16": ("paged_attention (bf16 mma.sync cluster body, int8 "
                     "pools)", "paddle_tpu_torch/csrc/paged_attention.cu",
                     "paddle_tpu/ops/pallas/paged_attention.py:134"),
}
# the row each kernel reports in the kernels line: for K2, K4 and K5
# fp32 (the serving phase's dtype) at the decode shape for K2 and K4,
# and the deepest prefix for K5; for K4's and K5's bf16 bodies (phase
# 5c's) bf16 at the decode shape and the deepest prefix; for the flash
# kernels bf16 (the training phase's dtype under AMP) at the shape of the
# path that launches them.
# id -> (row's kernel, dtype, shape)
_K5_DEEP = [128, 517, 12, 64, 16, 64]
HEADLINE = {"K1": ("K1", "bfloat16", list(FLASH_CASES[0])),
            "K2": ("K2", "float32", [8, 768]),
            "K3a": ("K3a", "bfloat16", list(FLASH_CASES[0])),
            "K3b-dkv": ("K3b-dkv", "bfloat16", list(FLASH_LONG)),
            "K3b-dq": ("K3b-dq", "bfloat16", list(FLASH_LONG)),
            "K4": ("K4", "float32", [8, 1, 12, 64, 16, 64]),
            "K5": ("K5", "float32", _K5_DEEP),
            "K4-int8": ("K4-int8", "float32", [8, 1, 12, 64, 16, 64]),
            "K5-int8": ("K5-int8", "float32", _K5_DEEP),
            "K5-bf16": ("K5", "bfloat16", _K5_DEEP),
            "K5-int8-bf16": ("K5-int8", "bfloat16", _K5_DEEP),
            "K4-bf16": ("K4", "bfloat16", [8, 1, 12, 64, 16, 64]),
            "K4-int8-bf16": ("K4-int8", "bfloat16", [8, 1, 12, 64, 16, 64])}


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
    mark = [time.perf_counter()]

    def lap(phase):
        now = time.perf_counter()
        print(f"phase {phase}: {now - mark[0]:.1f} s wall", flush=True)
        mark[0] = now

    build_phase()
    ptxas_phase()
    lap("build + ptxas")
    timer = Timer(torch)
    rows = []
    print("kernels vs plain versions (device ms, cold L2):", flush=True)
    layer_norm_phase(torch, timer, rows)
    decode_phase(torch, timer, rows, int8=False)
    chunk_phase(torch, timer, rows, int8=False)
    decode_phase(torch, timer, rows, int8=True)
    chunk_phase(torch, timer, rows, int8=True)
    lap("K2, K4, K5")
    long_launches = flash_phase(torch, timer, rows)
    lap("flash")
    launches, model, fp_agg = serving_phase(torch, card)
    lap("serving")
    q_launches = serving_q_phase(torch, card, model, fp_agg)
    lap("int8 serving")
    launches.update({k: q_launches[k] for k in ("K4-int8", "K5-int8")})
    del model
    bf16_launches, bf16_q_launches = serving_bf16_phase(torch, card)
    lap("bf16 serving")
    launches.update({"K5-bf16": bf16_launches["K5"],
                     "K5-int8-bf16": bf16_q_launches["K5-int8"],
                     "K4-bf16": bf16_launches["K4"],
                     "K4-int8-bf16": bf16_q_launches["K4-int8"]})
    train_launches = training_phase(torch, card)
    lap("training")
    launches.update({"K1": train_launches["K1"], "K3a": train_launches["K3a"],
                     "K3b-dkv": long_launches["bwd_dkv"],
                     "K3b-dq": long_launches["bwd_dq"]})

    out = []
    for kid, (name, src, replaces) in KERNELS.items():
        row = next(r for r in rows if [r["kernel"], r["dtype"], r["shape"]]
                   == list(HEADLINE[kid]))
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
