#!/usr/bin/env python3
"""Design variants of K3's bf16 bodies, timed side by side on one card.

Run from the root of a checkout on one Hopper card (``nvcc`` and
PyTorch built for CUDA): ``python3 k3_variants.py [NAME ...]`` (the
named variants of ``VARIANTS``, by default all). Each variant is a set
of text patches on ``csrc/flash_bwd.cu``: the bodies as built, and the
choices their designs rejected (for the dK/dV body, K3a and K3b-dkv, and
for the dQ body, K3b-dq, whose names start with "dQ:"). For each one it
copies the port into a fresh temporary directory and patches the copy
(``k1_fault_check.copy_patched``; the checkout is never edited), builds
every copy at once, then prints per variant

- ``nvcc -Xptxas -v``'s registers and spills of each bf16 K3
  instantiation (``flash_bwd_mma_kernel<D, WITH_DQ>``,
  ``flash_dq_mma_kernel<D>``);
- one JSON line per timed shape of ``chip_smoke.py`` (``FLASH_CASES``
  and ``FLASH_LONG``, bf16, lse from K1): K3a's, K3b-dkv's and K3b-dq's
  device time (``chip_smoke.Timer``: median of single launches, cold
  L2) and their largest share of ``K3_TOL``; then K3b-dkv's and
  K3b-dq's time, unchecked, on the streaming route at ``ROUTE_SHAPE``.

The variants run one after another in one process each, so their times
compare within the call. It exits non-zero if a variant's run fails.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

# name -> [(source text in csrc/flash_bwd.cu, replacement), ...]
VARIANTS = {
    "as built": [],
    # a register cap of 168 (3 CTAs an SM)
    "D 64 at 3 CTAs an SM": [(
        "__global__ void __launch_bounds__(kMmaThreads, 2)\n"
        "    flash_bwd_mma_kernel(",
        "__global__ void __launch_bounds__(kMmaThreads, D == 64 ? 3 : 2)\n"
        "    flash_bwd_mma_kernel(")],
    "D 128 chunk loop unrolled": [(
        "#pragma unroll(D == 64 ? kTile / QC : 1)", "#pragma unroll")],
    # the grid's axes swapped: every head's key tile 0 (the longest
    # causal sweep) launches before any head's key tile 1
    "heads fastest": [
        ("  const int k0 = blockIdx.x * kTile, kw = k0 + warp * 16;\n"
         "  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;\n",
         "  const int k0 = blockIdx.y * kTile, kw = k0 + warp * 16;\n"
         "  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;\n"),
        ("  const dim3 grid((a.Sk + kTile - 1) / kTile, a.B * a.H);\n"
         "  return fused ? launch(flash_bwd_mma_kernel",
         "  const dim3 grid(a.B * a.H, (a.Sk + kTile - 1) / kTile);\n"
         "  return fused ? launch(flash_bwd_mma_kernel")],
    # the dQ body's CTAs in query-tile order (the shortest causal sweep
    # first)
    "dQ: natural grid order": [(
        "  const int tile = a.causal ? gridDim.x - 1 - blockIdx.x : "
        "blockIdx.x;\n",
        "  const int tile = blockIdx.x;\n")],
    # with a chunk narrower than a tile, a warp skips the diagonal
    # tile's chunks whose keys all lie past its rows
    "dQ: 32 keys per chunk": [
        ("  constexpr int KC = 64;           // keys per chunk of a key tile\n",
         "  constexpr int KC = 32;           // keys per chunk of a key tile\n"),
        ("      // S = Q_w K^T and dP = dO_w V^T over this chunk's keys\n",
         "      if (a.causal && k0 + c > w0 + 15) continue;\n"
         "      // S = Q_w K^T and dP = dO_w V^T over this chunk's keys\n")],
    # Q and dO fragments loaded from shared memory at each use (the
    # registers freed, the loads repeated per key chunk)
    "dQ: fragments re-read": [
        ("  uint32_t qf[KD][4], df[KD][4];\n#pragma unroll\n"
         "  for (int kd = 0; kd < KD; ++kd) {\n"
         "    mma::ldsm_x4(qf[kd], mma::a_x4<LDS>(qs, warp * 16, kd * 16, "
         "lane));\n"
         "    mma::ldsm_x4(df[kd], mma::a_x4<LDS>(dos, warp * 16, kd * 16, "
         "lane));\n  }\n",
         "  uint32_t qf[KD][4], df[KD][4];\n"),
        ("      for (int kd = 0; kd < KD; ++kd) {\n#pragma unroll\n"
         "        for (int n = 0; n < NC; n += 2) {\n"
         "          uint32_t bk[4], bv[4];\n",
         "      for (int kd = 0; kd < KD; ++kd) {\n"
         "        mma::ldsm_x4(qf[kd], mma::a_x4<LDS>(qs, warp * 16, kd * 16, "
         "lane));\n"
         "        mma::ldsm_x4(df[kd], mma::a_x4<LDS>(dos, warp * 16, kd * 16, "
         "lane));\n#pragma unroll\n"
         "        for (int n = 0; n < NC; n += 2) {\n"
         "          uint32_t bk[4], bv[4];\n")],
}

# (B, S, H, D): gpt2_small's 12 heads at a 16k context, causal; many
# waves of CTAs where chip_smoke.py's S 8320 (B 1, H 2) is one
ROUTE_SHAPE = (1, 16384, 12, 64)

_MMA = re.compile(r"flash_(bwd|dq)_mma_kernelILi(\d+)E(?:Lb(\d)E)?")


def _label(m) -> str:
    if m.group(1) == "dq":
        return f"K3b-dq D {m.group(2)}"
    return f"{'K3a' if m.group(3) == '1' else 'K3b-dkv'} D {m.group(2)}"


def child(build_only: bool):
    """Build this copy's kernels; unless ``build_only``, time K3a,
    K3b-dkv and K3b-dq at each timed shape, one JSON line each."""
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    _build.load_library()
    if build_only:
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    timer = cs.Timer(torch)
    shapes = [(s, 41 + i) for i, s in enumerate(cs.FLASH_CASES)]
    for (B, S, H, D, causal), seed in shapes + [(cs.FLASH_LONG, 47)]:
        q, k, v, do = cs._flash_inputs(torch, B, S, H, D, torch.bfloat16,
                                       seed)
        want, got, bwd = cs.k3_grads(torch, q, k, v, do, causal)
        print(json.dumps({
            "shape": [B, S, H, D, causal],
            "k3a_ms": timer(lambda: fa.flash_bwd_fused(*bwd), n=10),
            "k3b_dkv_ms": timer(lambda: fa.flash_bwd_dkv(*bwd), n=10),
            "k3b_dq_ms": timer(lambda: fa.flash_bwd_dq(*bwd), n=10),
            "k3_limit_share": max(
                max(cs.k3_errors("bfloat16", g, want).values())
                for g in got.values())}), flush=True)
    # the streaming route as gpt2_small would take it, timed only: its
    # plain backward would need 13 GB for one fp32 score tensor
    B, S, H, D = ROUTE_SHAPE
    q, k, v, do = cs._flash_inputs(torch, B, S, H, D, torch.bfloat16, 61)
    o, lse = fa.flash_fwd(q, k, v, D ** -0.5, True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    bwd = (q, k, v, do, lse, delta, D ** -0.5, True)
    print(json.dumps({
        "shape": [B, S, H, D, True], "timed only": True,
        "k3b_dkv_ms": timer(lambda: fa.flash_bwd_dkv(*bwd), n=10),
        "k3b_dq_ms": timer(lambda: fa.flash_bwd_dq(*bwd), n=10)}),
        flush=True)


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
    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {}
        unknown = set(names) - set(VARIANTS)
        if unknown:
            raise SystemExit(f"k3_variants: no variant {sorted(unknown)}")
        for i, (name, patches) in enumerate(VARIANTS.items()):
            if names and name not in names:
                continue
            dirs[name] = Path(tmp) / f"v{i}"
            k1_fault_check.copy_patched(root, dirs[name],
                                        Path(__file__).resolve(),
                                        "flash_bwd.cu", patches)
        me = Path(__file__).name
        procs = {n: (_ptxas(_build._nvcc(), _build.NVCC_FLAGS,
                            d / "paddle_tpu_torch/csrc/flash_bwd.cu",
                            d / "flash_bwd.o"),
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
                    label = m and _label(m)
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
        print("k3_variants: FAIL: " + "; ".join(bad), file=sys.stderr)
        sys.exit(1)
    print("k3_variants: ok", flush=True)


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
