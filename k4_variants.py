#!/usr/bin/env python3
"""Design variants of K4's bf16 cluster body, timed side by side on one card.

Run from the root of a checkout on one Hopper card (``nvcc`` and
PyTorch built for CUDA): ``python3 k4_variants.py [NAME ...]`` (the
named variants of ``VARIANTS``, by default all). Each variant is a set
of text patches on ``csrc/paged_attention.cu`` (and, where the design
needs it, on other files of the port): the body as built, and the
choices its design rejected: other cluster sizes (1, no split; 2; 4;
16, past the portable 8); the splits' partials merged through device
memory by a second small kernel, vLLM's v2 shape, in place of the
cluster's distributed shared memory; each warp walking whole 64-key
tiles of its own, in place of a quarter of every tile; and a 3-stage
ring. (The CUDA-core body that served bf16 q before this body was
redesigned for fp32 q alone, which ``k45_f32_variants.py`` times.) For
each one it
copies the port into a fresh temporary directory and patches the copy
(``k1_fault_check.copy_patched``; the checkout is never edited), builds
every copy at once, then prints per variant

- ``nvcc -Xptxas -v``'s registers and spills of each instantiation of
  ``paged_decode_mma_kernel<D, T, TP>`` (T bf16: the variants time bf16 q);
- one JSON line per bf16 K4 and K4-int8 case of ``chip_smoke.py``
  (``k4_case_inputs``): the device time (``chip_smoke.Timer``: median of
  single launches, cold L2) and the largest share of ``K4_TOL``.

The variants run one after another in one process each, so their times
compare within the call. It exits non-zero if a variant's run fails or
breaks K4_TOL.

``python3 k4_variants.py --serve [NAME ...]`` (by default the body as
built and clusters of 4) serves instead ``chip_smoke.py``'s phase
5c trace (``gpt2_small`` in bf16, 8 greedy requests, on bf16 and then
int8 pools) with each named variant's kernels, in the order A, B, B, A
for two: per run the decode-step p50, TTFT p50 and tokens/s (host
clock), and from one more run under ``torch.profiler`` the device time
of all kernels and of K4's alone, so that a step's time can be split
into the device's share and the host's.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path



def _splits(c):
    patches = [("constexpr int kSplits = 8;",
                f"constexpr int kSplits = {c};")]
    if c > 8:   # past the portable cluster size, if the card takes it
        patches.append((
            "                              static_cast<int>(DecodeSmem<D, "
            "TP>::bytes));\n}\n",
            "                              static_cast<int>(DecodeSmem<D, "
            "TP>::bytes)) != cudaSuccess\n"
            "             ? cudaGetLastError()\n"
            "             : cudaFuncSetAttribute(\n"
            "                   paged_decode_mma_kernel<D, T, TP>,\n"
            "                   cudaFuncAttributeNonPortableClusterSizeAllowed, "
            "1);\n}\n"))
    return patches


def _cluster_tail():
    """The body's text from its first cluster barrier to its end (read
    from the checkout's source: a patched copy no longer has it)."""
    src = (Path(__file__).resolve().parent / "paddle_tpu_torch" / "csrc"
           / "paged_attention.cu").read_text()
    return src[src.index("  // every rank's partial is in its shared "
                         "memory\n"):
               src.index("template <int D, typename T, typename TP>\n"
                         "cudaError_t prepare_decode")]


# v2: no cluster (cluster dims 1, the rank from blockIdx.x); each CTA
# writes its rows' partial m, l and o to a workspace in device memory
# (grown by cudaMalloc, its address in a __device__ symbol), and a
# second kernel, one CTA per (slot, head), merges the kSplits partials
_V2 = [
    ("constexpr float kLog2e = 1.4426950408889634f;\n",
     "constexpr float kLog2e = 1.4426950408889634f;\n"
     "__device__ float* d_part;  // [b * H][tiles][kSplits][kMaxRows][D + 2]\n"
     "float* g_ws = nullptr;\n"
     "size_t g_ws_n = 0;\n"),
    ("  const int rank = static_cast<int>(cluster.block_rank());\n",
     "  const int rank = blockIdx.x;\n"),
    (_cluster_tail,
     "  __syncthreads();\n"
     "  float* part = d_part + ((static_cast<int64_t>(blockIdx.y) *\n"
     "                           gridDim.z + blockIdx.z) * kSplits + rank) *\n"
     "                              kMaxRows * (D + 2);\n"
     "  for (int e = threadIdx.x; e < nrows * (D + 2); e += kMmaThreads) {\n"
     "    const int row = e / (D + 2), c = e % (D + 2);\n"
     "    part[e] = c < D ? po[row * D + c] : c == D ? pm[row] : pl[row];\n"
     "  }\n"
     "}\n\n"
     "template <int D>\n"
     "__global__ void __launch_bounds__(128)\n"
     "    decode_merge_kernel(bf16* __restrict__ out, int s, int H) {\n"
     "  namespace mma = ptt::mma;\n"
     "  const int slot = blockIdx.x / H, h = blockIdx.x % H;\n"
     "  const int row0 = blockIdx.y * kMaxRows;\n"
     "  const int nrows = min(kMaxRows, s - row0);\n"
     "  const int64_t rs = static_cast<int64_t>(H) * D;\n"
     "  const float* part = d_part + (static_cast<int64_t>(blockIdx.x) *\n"
     "                                gridDim.y + blockIdx.y) *\n"
     "                                   kSplits * kMaxRows * (D + 2);\n"
     "  constexpr int OC = D / 8;\n"
     "  for (int idx = threadIdx.x; idx < nrows * OC; idx += blockDim.x) {\n"
     "    const int row = idx / OC, c = idx % OC;\n"
     "    float mr[kSplits];\n"
     "    float mm = ptt::kMaskedLogit;\n"
     "#pragma unroll\n"
     "    for (int r = 0; r < kSplits; ++r) {\n"
     "      mr[r] = __ldcg(part + (r * kMaxRows + row) * (D + 2) + D);\n"
     "      mm = fmaxf(mm, mr[r]);\n"
     "    }\n"
     "    float ls = 0.f, acc[8] = {0.f};\n"
     "#pragma unroll\n"
     "    for (int r = 0; r < kSplits; ++r) {\n"
     "      const float* pr = part + (r * kMaxRows + row) * (D + 2);\n"
     "      const float a = exp2f(mr[r] - mm);\n"
     "      ls += __ldcg(pr + D + 1) * a;\n"
     "#pragma unroll\n"
     "      for (int e = 0; e < 8; ++e) acc[e] += __ldcg(pr + c * 8 + e) * a;\n"
     "    }\n"
     "    const float inv = 1.f / ls;\n"
     "    *reinterpret_cast<uint4*>(out + (static_cast<int64_t>(slot) * s +\n"
     "                                     row0 + row) * rs + h * D + c * 8) =\n"
     "        make_uint4(mma::pack_bf16(acc[0] * inv, acc[1] * inv),\n"
     "                   mma::pack_bf16(acc[2] * inv, acc[3] * inv),\n"
     "                   mma::pack_bf16(acc[4] * inv, acc[5] * inv),\n"
     "                   mma::pack_bf16(acc[6] * inv, acc[7] * inv));\n"
     "  }\n"
     "}\n\n"),
    ("  attr->val.clusterDim.x = kSplits;\n",
     "  attr->val.clusterDim.x = 1;\n"),
    ("  cudaLaunchAttribute attr;\n"
     "  const cudaLaunchConfig_t cfg = decode_config<D, TP>(b, s, H, st, &attr);\n",
     "  const size_t need = static_cast<size_t>(b) * H *\n"
     "                      ((s + kMaxRows - 1) / kMaxRows) * kSplits *\n"
     "                      kMaxRows * (D + 2);\n"
     "  if (need > g_ws_n) {\n"
     "    if (g_ws != nullptr) cudaFree(g_ws);\n"
     "    e = cudaMalloc(&g_ws, need * sizeof(float));\n"
     "    if (e != cudaSuccess) return e;\n"
     "    g_ws_n = need;\n"
     "    e = cudaMemcpyToSymbol(d_part, &g_ws, sizeof(g_ws));\n"
     "    if (e != cudaSuccess) return e;\n"
     "  }\n"
     "  cudaLaunchAttribute attr;\n"
     "  const cudaLaunchConfig_t cfg = decode_config<D, TP>(b, s, H, st, &attr);\n"),
    ("                         static_cast<T*>(out), s, H, dh, bs, bp, scale);\n"
     "  if (e != cudaSuccess) return e;\n",
     "                         static_cast<T*>(out), s, H, dh, bs, bp, scale);\n"
     "  if (e != cudaSuccess) return e;\n"
     "  decode_merge_kernel<D><<<dim3(b * H, (s + kMaxRows - 1) / kMaxRows),\n"
     "                           128, 0, st>>>(static_cast<bf16*>(out), s, H);\n"),
]

# name -> [(source text in csrc/paged_attention.cu, replacement), ...]; a
# triple (file under paddle_tpu_torch/, text, replacement) patches that
# file
VARIANTS = {
    "as built": [],
    "C = 1 (no split)": _splits(1),
    "C = 2": _splits(2),
    "C = 4": _splits(4),
    "C = 16 (non-portable)": _splits(16),
    "(v2) merge in device memory by a second kernel": _V2,
    # warp w walks tiles w, w + 4, ... of the rank's, 64 keys each
    "warps walk whole tiles": [(
        "constexpr int kWarpKeys = 16;", "constexpr int kWarpKeys = 64;")],
    # two slices in flight while the third is read
    "3-stage ring": [(
        "constexpr int kStages = 2;", "constexpr int kStages = 3;")],
}

_MMA = re.compile(r"paged_decode_mma_kernelILi(\d+)E13__nv_bfloat16(a|S\d*_)E")


def child(build_only: bool):
    """Build this copy's kernels; unless ``build_only``, time every bf16
    K4 case, one JSON line each."""
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import paged_attention as k4

    _build.load_library()
    if build_only:
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    timer = cs.Timer(torch)
    bad = False
    for int8 in (False, True):
        for case in cs.k4_case_inputs(torch, torch.bfloat16, int8):
            outs, _, exact = cs.k4_run(torch, case)
            share = cs.k4_share(int8, outs, exact)
            q, table_t, t = case["q"], case["table_t"], case["t"]
            (kc, vc), sc = (case["pools"] if int8
                            else (case["pools"], (None, None)))
            ms = timer(lambda: k4.paged_attention(q, kc, vc, table_t, t,
                                                  k_scale=sc[0],
                                                  v_scale=sc[1]))
            bad |= not share <= 1.0
            print(json.dumps({"pools": "int8" if int8 else "bf16",
                              "case": case["shape"], "kernel_ms": ms,
                              "k4_limit_share": share}), flush=True)
    if bad:
        sys.exit("a case breaks K4_TOL")


def child_serve():
    """Phase 5c's bf16 serving trace on this copy's kernels, bf16 and then
    int8 pools: one timed run, then one under ``torch.profiler`` for the
    device time by kernel; one JSON line each."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_small

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = gpt2_small()
    model = GPTForCausalLM(cfg, device="cuda", seed=0, dtype=torch.bfloat16)
    model.eval()
    trace = [kw for kw in cs._serving_trace(cfg.vocab_size)
             if kw.get("greedy")][:8]
    for kv in (None, "int8"):
        _, _, agg, wall, _ = cs._serve(torch, model, trace, kv_dtype=kv)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            cs._serve(torch, model, trace, kv_dtype=kv)
        kernels = [(e.key, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        steps = int(agg["decode_steps"])
        print(json.dumps({
            "pools": "int8" if kv else "bf16", "decode_steps": steps,
            "decode_step_ms_p50": agg["decode_step_ms_p50"],
            "ttft_ms_p50": agg["ttft_p50_s"] * 1e3,
            "tokens_per_s": agg["aggregate_tokens_per_s"], "wall_s": wall,
            "device_ms": sum(ms for _, ms in kernels),
            "k4_device_ms_per_step": sum(
                ms for k, ms in kernels if "paged_decode" in k) / steps}),
              flush=True)


def _ptxas(nvcc, flags, src: Path, obj: Path):
    return subprocess.Popen([nvcc, *flags, "-Xptxas", "-v", "-c", str(src),
                             "-o", str(obj)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def main(names, serve=False):
    import k1_fault_check
    from paddle_tpu_torch.ops.kernels import _build

    root = Path(__file__).resolve().parent
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    if serve and not names:
        names = ["as built", "C = 4"]
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"k4_variants: no variant {sorted(unknown)}")
    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {}
        for i, (name, patches) in enumerate(VARIANTS.items()):
            if names and name not in names:
                continue
            dirs[name] = Path(tmp) / f"v{i}"
            k1_fault_check.copy_patched(
                root, dirs[name], Path(__file__).resolve(),
                "paged_attention.cu",
                [(old() if callable(old) else old, new)
                 for old, new in (p for p in patches if len(p) == 2)])
            for rel, old, new in (p for p in patches if len(p) == 3):
                f = dirs[name] / "paddle_tpu_torch" / rel
                text = f.read_text()
                if text.count(old) != 1:
                    raise SystemExit(f"k4_variants: a patched text is not in "
                                     f"{rel} exactly once:\n{old}")
                f.write_text(text.replace(old, new))
        me = Path(__file__).name
        procs = {n: (_ptxas(_build._nvcc(), _build.NVCC_FLAGS,
                            d / "paddle_tpu_torch/csrc/paged_attention.cu",
                            d / "paged_attention.o"),
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
        # every variant once; to serve, A, B, B, A (two variants)
        order = [n for n in dirs if n in regs]
        if serve:
            order += order[::-1]
        for n in order:
            if not serve:
                print(f"== {n}", flush=True)
                for label, spill, used in regs[n]:
                    print(f"  ptxas {label}: {used}, {spill}", flush=True)
            run = subprocess.run(
                [sys.executable, me, "--child", *(["--serve"] if serve
                                                  else [])],
                cwd=dirs[n], capture_output=True, text=True, timeout=900)
            for line in run.stdout.splitlines():
                if line.startswith("{"):
                    print("  " + json.dumps({"variant": n,
                                             **json.loads(line)}), flush=True)
            if run.returncode != 0:
                print(run.stderr[-3000:], file=sys.stderr, flush=True)
                bad.append(f"{n}: the run failed (rc {run.returncode})")
    if bad:
        print("k4_variants: FAIL: " + "; ".join(bad), file=sys.stderr)
        sys.exit(1)
    print("k4_variants: ok", flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", help="variants to run (default all)")
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--build-only", action="store_true")
    ap.add_argument("--serve", action="store_true",
                    help="serve phase 5c's trace, A B B A, instead")
    args = ap.parse_args()
    if args.child and args.serve:
        child_serve()
    elif args.child:
        child(args.build_only)
    else:
        main(args.names, args.serve)
