#!/usr/bin/env python3
"""Design variants of K5's bf16 body, timed side by side on one card.

Run from the root of a checkout on one Hopper card (``nvcc`` and
PyTorch built for CUDA): ``python3 k5_variants.py [NAME ...]`` (the
named variants of ``VARIANTS``, by default all). Each variant is a set
of text patches on ``csrc/chunk_prefill.cu`` (and, where the design
needs it, on other files of the port): the body as built, and the
choices its design rejected: (a) a split of each CTA's key range over
several CTAs, merged by the last of them; (b) a 3-stage ring; (c) int8
codes turned into fragments as they are loaded, in place of the
conversion pass; and the chunk's tiles in row order. For each one it copies the port into a
fresh temporary directory and patches the copy
(``k1_fault_check.copy_patched``; the checkout is never edited), builds
every copy at once, then prints per variant

- ``nvcc -Xptxas -v``'s registers and spills of each instantiation of
  ``chunk_prefill_mma_kernel<D, T, TP>`` (T bf16: the variants time bf16 q);
- one JSON line per bf16 K5 and K5-int8 case of ``chip_smoke.py``
  (``k5_case_inputs``), and per shape of ``EXTRA_SHAPES``: the device
  time (``chip_smoke.Timer``: median of single launches, cold L2) and
  the largest share of ``K5_TOL``.

The variants run one after another in one process each, so their times
compare within the call. It exits non-zero if a variant's run fails or
breaks K5_TOL.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

# (a): each CTA's key range in splits of SPLIT_TILES tiles over
# blockIdx.z; a split that is one of several writes its rows' O / l, m
# and l to scratch from the wrapper, and the last of them to finish (a
# counter per CTA, reset by it) merges them by their logsumexp and
# writes O. The scratch comes from the wrapper, so the C entry takes
# three more arguments (in the copy's _build.py too).
SPLIT_TILES = 4
_SPLIT = [
    ("  int bs, int bp, float scale) {\n",
     "  int bs, int bp, float scale, float* __restrict__ part,\n"
     "  int* __restrict__ sem, int tps) {\n"),
    ("  const int n_tiles = reach / kKeys + 1;\n",
     "  const int n_all = reach / kKeys + 1;\n"
     "  const int nact = (n_all + tps - 1) / tps, z = blockIdx.z;\n"
     "  if (z >= nact) return;\n"
     "  const int j_lo = z * tps, n_tiles = min(n_all, j_lo + tps);\n"),
    ("    if (st < n_tiles) stage_tile(st, st);\n",
     "    if (j_lo + st < n_tiles) stage_tile(j_lo + st, (j_lo + st) % "
     "kStages);\n"),
    ("  for (int j = 0; j < n_tiles; ++j) {\n",
     "  for (int j = j_lo; j < n_tiles; ++j) {\n"),
    # a row with no key in its split keeps m = -1e30: its p is 0
    ("        const float p = exp2f(sc[n][e] - m[e / 2]);\n",
     "        const float p = m[e / 2] == ptt::kMaskedLogit\n"
     "                            ? 0.f : exp2f(sc[n][e] - m[e / 2]);\n"),
    ("  if (!warp_live) return;\n\n#pragma unroll\n"
     "  for (int i = 0; i < 2; ++i) {\n"
     "    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);\n"
     "    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);\n"
     "    l[i] /= f;  // O = o * f / l (f = 1 for 16-bit pools)\n  }\n",
     "#pragma unroll\n"
     "  for (int i = 0; i < 2; ++i) {\n"
     "    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);\n"
     "    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);\n"
     "    l[i] /= f;  // O = o * f / l (f = 1 for 16-bit pools)\n  }\n"
     "  if (nact > 1) {\n"
     "    constexpr int RW = D + 2;  // a row: O / l, then m, l\n"
     "    float* pc = part + ((static_cast<int64_t>(z) * gridDim.y + h) *\n"
     "                            gridDim.x + blockIdx.x) * kRows * RW;\n"
     "    const int64_t zs = static_cast<int64_t>(gridDim.y) * gridDim.x *\n"
     "                       kRows * RW;  // from one split to the next\n"
     "    if (warp_live) {\n"
     "#pragma unroll\n"
     "      for (int i = 0; i < 2; ++i) {\n"
     "        const int r = warp * 16 + g + 8 * i;\n"
     "        const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;\n"
     "#pragma unroll\n"
     "        for (int n = 0; n < ND; ++n)\n"
     "          *reinterpret_cast<float2*>(pc + r * RW + n * 8 + 2 * t) =\n"
     "              make_float2(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);\n"
     "        if (t == 0) {\n"
     "          pc[r * RW + D] = m[i];\n"
     "          pc[r * RW + D + 1] = l[i] * f;  // the softmax's own l\n"
     "        }\n"
     "      }\n"
     "    }\n"
     "    __threadfence();\n"
     "    __syncthreads();\n"
     "    __shared__ int last;\n"
     "    if (threadIdx.x == 0) {\n"
     "      int* cnt = sem + blockIdx.y * gridDim.x + blockIdx.x;\n"
     "      last = atomicAdd(cnt, 1) == nact - 1;\n"
     "      if (last) *cnt = 0;  // ready for the next launch\n"
     "    }\n"
     "    __syncthreads();\n"
     "    if (!last) return;\n"
     "    __threadfence();\n"
     "    float* p0 = pc - z * zs;  // split 0 of this CTA\n"
     "    T* oh = out + static_cast<int64_t>(slot) * s * rs + h * D;\n"
     "    for (int idx = threadIdx.x; idx < rows * (D / 8);\n"
     "         idx += kMmaThreads) {\n"
     "      const int r = idx / (D / 8), c = idx % (D / 8);\n"
     "      float mm = ptt::kMaskedLogit, w[8] = {0.f}, lsum = 0.f;\n"
     "      for (int y = 0; y < nact; ++y)\n"
     "        mm = fmaxf(mm, __ldcg(p0 + y * zs + r * RW + D));\n"
     "      for (int y = 0; y < nact; ++y) {\n"
     "        const float* pr = p0 + y * zs + r * RW;\n"
     "        const float wy = __ldcg(pr + D + 1) * exp2f(__ldcg(pr + D) - mm);\n"
     "        lsum += wy;\n"
     "#pragma unroll\n"
     "        for (int e = 0; e < 8; ++e) w[e] += wy * __ldcg(pr + c * 8 + e);\n"
     "      }\n"
     "      uint4 v;\n"
     "      v.x = E::pack(w[0] / lsum, w[1] / lsum);\n"
     "      v.y = E::pack(w[2] / lsum, w[3] / lsum);\n"
     "      v.z = E::pack(w[4] / lsum, w[5] / lsum);\n"
     "      v.w = E::pack(w[6] / lsum, w[7] / lsum);\n"
     "      *reinterpret_cast<uint4*>(oh + (r0 + r) * rs + c * 8) = v;\n"
     "    }\n"
     "    return;\n"
     "  }\n"
     "  if (!warp_live) return;\n"),
    ("template <int D, typename T, typename TP>\n"
     "cudaError_t launch_mma(const void* q, const void* kp, const void* vp,\n",
     "float* g_part;  // the entry's split arguments\n"
     "int* g_sem;\n"
     "int g_nsplit;\n\n"
     "template <int D, typename T, typename TP>\n"
     "cudaError_t launch_mma(const void* q, const void* kp, const void* vp,\n"),
    ("  const dim3 grid(b * ntile, H);\n",
     "  const int tiles = (bp * bs + kKeys - 1) / kKeys;\n"
     "  const dim3 grid(b * ntile, H, g_nsplit);\n"),
    ("      ntile, H, dh, bs, bp, scale);\n",
     "      ntile, H, dh, bs, bp, scale, g_part, g_sem,\n"
     "      (tiles + g_nsplit - 1) / g_nsplit);\n"),
    ("                                     float scale, int dtype, int pool,\n"
     "                                     void* stream) {\n",
     "                                     float scale, int dtype, int pool,\n"
     "                                     void* part, void* sem, int nsplit,\n"
     "                                     void* stream) {\n"
     "  g_part = static_cast<float*>(part);\n"
     "  g_sem = static_cast<int*>(sem);\n"
     "  g_nsplit = nsplit;\n"),
    ("ops/kernels/_build.py",
     '"ptt_chunk_prefill_fwd": [_VP] * 8 + [_I] * 7 + [_F, _I, _I, _VP],',
     '"ptt_chunk_prefill_fwd": [_VP] * 8 + [_I] * 7 + [_F, _I, _I, _VP, '
     '_VP, _I, _VP],'),
    ("ops/kernels/chunk_prefill.py",
     "    out = torch.empty_like(q)\n    lib = _build.load_library()\n",
     "    out = torch.empty_like(q)\n"
     "    ntile = -(-s // 64)\n"
     "    tiles = -(-table.shape[1] * k_pool.shape[1] // 64)\n"
     f"    nsplit = -(-tiles // {SPLIT_TILES})\n"
     "    part = torch.empty(nsplit * b * ntile * h * 64 * (d + 2),\n"
     "                       dtype=torch.float32, device=q.device)\n"
     "    if _SEM.get(q.device, torch.empty(0)).numel() < b * ntile * h:\n"
     "        _SEM[q.device] = torch.zeros(b * ntile * h, dtype=torch.int32,\n"
     "                                     device=q.device)\n"
     "    lib = _build.load_library()\n"),
    ("ops/kernels/chunk_prefill.py",
     "        float(scale), _DTYPES[q.dtype], pool,\n",
     "        float(scale), _DTYPES[q.dtype], pool, part.data_ptr(),\n"
     "        _SEM[q.device].data_ptr(), nsplit,\n"),
    ("ops/kernels/chunk_prefill.py",
     "MAX_QBS = 64\n",
     "MAX_QBS = 64\n_SEM = {}\n"),
]

# name -> [(source text in csrc/chunk_prefill.cu, replacement), ...]; a
# triple (file under paddle_tpu_torch/, text, replacement) patches that
# file
VARIANTS = {
    "as built": [],
    "(a) split key range, merged by its last split": _SPLIT,
    # two tiles in flight while the third is read
    "(b) 3-stage ring": [(
        "constexpr int kStages = 2;       // cp.async ring depth\n",
        "constexpr int kStages = 3;       // cp.async ring depth\n")],
    # int8 pools: no conversion pass (nor its barrier); each lane builds
    # its B fragments from the codes in the ring, two a register, turned
    # into bf16 (K) and fp16 (V) on the way
    "(c) int8 codes into fragments": [
        ("    if constexpr (kCode) {\n"
         "      // codes -> T (K) and fp16 (V), 16 a chunk",
         "    if constexpr (false) {\n"
         "      // codes -> T (K) and fp16 (V), 16 a chunk"),
        ("        mma::ldsm_x4(kf, mma::b_x4<LDS>(kt, n * 8, kd * 16, lane));\n",
         "        if constexpr (kCode) {\n"
         "#pragma unroll\n"
         "          for (int x = 0; x < 2; ++x) {\n"
         "            const TP* p = kr + (st * kKeys + (n + x) * 8 + g) * D +\n"
         "                          kd * 16 + 2 * t;\n"
         "            kf[2 * x] = mma::pack_bf16(p[0], p[1]);\n"
         "            kf[2 * x + 1] = mma::pack_bf16(p[8], p[9]);\n"
         "          }\n"
         "        } else {\n"
         "          mma::ldsm_x4(kf, mma::b_x4<LDS>(kt, n * 8, kd * 16, lane));\n"
         "        }\n"),
        ("        mma::ldsm_x4_trans(vf, mma::bt_x4<LDS>(vt, kk * 16, n * 8, "
         "lane));\n",
         "        if constexpr (kCode) {\n"
         "#pragma unroll\n"
         "          for (int x = 0; x < 2; ++x) {\n"
         "            const TP* p = vr + (st * kKeys + kk * 16 + 2 * t) * D +\n"
         "                          (n + x) * 8 + g;\n"
         "            vf[2 * x] = mma::pack_f16(p[0], p[D]);\n"
         "            vf[2 * x + 1] = mma::pack_f16(p[8 * D], p[9 * D]);\n"
         "          }\n"
         "        } else {\n"
         "          mma::ldsm_x4_trans(vf, mma::bt_x4<LDS>(vt, kk * 16, n * 8, "
         "lane));\n"
         "        }\n")],
    # the chunk's tiles in row order (the shortest sweep first)
    "natural grid order": [(
        "  const int tile = ntile - 1 - blockIdx.x % ntile;\n",
        "  const int tile = blockIdx.x % ntile;\n")],
}

# timed beside the phase-3 cases, bf16 pools: a chunk of 128 at start
# 300, the yardstick of the chunk of 100 there (a chunk length of no
# power of two must not be slower than a longer one)
EXTRA_SHAPES = ((128, 300),)

_MMA = re.compile(r"chunk_prefill_mma_kernelILi(\d+)E13__nv_bfloat16(a|S\d*_)E")


def child(build_only: bool):
    """Build this copy's kernels; unless ``build_only``, time every bf16
    K5 case, one JSON line each."""
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import chunk_prefill as k5

    _build.load_library()
    if build_only:
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    timer = cs.Timer(torch)
    bad = False
    for int8, shapes in ((False, None), (True, None), (False, EXTRA_SHAPES)):
        for case in cs.k5_case_inputs(torch, torch.bfloat16, int8, shapes):
            outs, _, exact = cs.k5_run(torch, case)
            share = cs.k5_share(int8, outs, exact)
            q, table_t, t = case["q"], case["table_t"], case["t"]
            (kc, vc), sc = (case["pools"] if int8
                            else (case["pools"], (None, None)))
            ms = timer(lambda: k5.chunk_prefill(q, kc, vc, table_t, t,
                                                k_scale=sc[0],
                                                v_scale=sc[1]))
            bad |= not share <= 1.0
            print(json.dumps({"pools": "int8" if int8 else "bf16",
                              "case": case["shape"], "kernel_ms": ms,
                              "k5_limit_share": share}), flush=True)
    if bad:
        sys.exit("a case breaks K5_TOL")


def _ptxas(nvcc, flags, src: Path, obj: Path):
    return subprocess.Popen([nvcc, *flags, "-Xptxas", "-v", "-c", str(src),
                             "-o", str(obj)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def main(names):
    import k1_fault_check
    from paddle_tpu_torch.ops.kernels import _build

    root = Path(__file__).resolve().parent
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"k5_variants: no variant {sorted(unknown)}")
    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {}
        for i, (name, patches) in enumerate(VARIANTS.items()):
            if names and name not in names:
                continue
            dirs[name] = Path(tmp) / f"v{i}"
            k1_fault_check.copy_patched(root, dirs[name],
                                        Path(__file__).resolve(),
                                        "chunk_prefill.cu",
                                        [p for p in patches if len(p) == 2])
            for rel, old, new in (p for p in patches if len(p) == 3):
                f = dirs[name] / "paddle_tpu_torch" / rel
                text = f.read_text()
                if text.count(old) != 1:
                    raise SystemExit(f"k5_variants: a patched text is not in "
                                     f"{rel} exactly once:\n{old}")
                f.write_text(text.replace(old, new))
        me = Path(__file__).name
        procs = {n: (_ptxas(_build._nvcc(), _build.NVCC_FLAGS,
                            d / "paddle_tpu_torch/csrc/chunk_prefill.cu",
                            d / "chunk_prefill.o"),
                     subprocess.Popen([sys.executable, me, "--child",
                                       "--build-only"], cwd=d))
                 for n, d in dirs.items()}
        regs = {}
        for n, (px, build) in procs.items():
            out = px.communicate()[0]
            if px.returncode != 0 or build.wait() != 0:
                bad.append(f"{n}: the build failed")
                print(out[-3000:], file=sys.stderr, flush=True)
                continue
            label, regs[n] = None, []
            for line in out.splitlines():
                if "Compiling entry function" in line:
                    m = _MMA.search(line)
                    label = m and (f"pool {'int8' if m.group(2) == 'a' else 'bf16'}"
                                   f", D {m.group(1)}")
                elif label and "spill stores" in line:
                    regs[n].append([label, line.strip()])
                elif label and "Used" in line:
                    regs[n][-1].append(line.split("Used", 1)[1].split(",")[0]
                                       .strip())
                    label = None
        for n, d in dirs.items():
            if n not in regs:
                continue
            print(f"== {n}", flush=True)
            for label, spill, used in regs[n]:
                print(f"  ptxas {label}: {used}, {spill}", flush=True)
            run = subprocess.run([sys.executable, me, "--child"], cwd=d,
                                 capture_output=True, text=True, timeout=900)
            for line in run.stdout.splitlines():
                if line.startswith("{"):
                    print("  " + json.dumps({"variant": n,
                                             **json.loads(line)}), flush=True)
            if run.returncode != 0:
                print(run.stderr[-3000:], file=sys.stderr, flush=True)
                bad.append(f"{n}: the run failed (rc {run.returncode})")
    if bad:
        print("k5_variants: FAIL: " + "; ".join(bad), file=sys.stderr)
        sys.exit(1)
    print("k5_variants: ok", flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", help="variants to run (default all)")
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--build-only", action="store_true")
    args = ap.parse_args()
    if args.child:
        child(args.build_only)
    else:
        main(args.names)
