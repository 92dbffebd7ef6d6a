#!/usr/bin/env python3
"""Design variants of K3's bf16 dK/dV body, timed side by side on one card.

Run from the root of a checkout on one Hopper card (``nvcc`` and
PyTorch built for CUDA): ``python3 k3_variants.py``. Each variant of
``VARIANTS`` is a set of text patches on ``csrc/flash_bwd.cu``: the
body as built, and the choices its design rejected. For each one it
copies the port into a fresh temporary directory and patches the copy
(``k1_fault_check.copy_patched``; the checkout is never edited), builds
every copy at once, then prints per variant

- ``nvcc -Xptxas -v``'s registers and spills of each bf16 K3a / K3b-dkv
  instantiation (``flash_bwd_mma_kernel<D, WITH_DQ>``);
- one JSON line per timed shape of ``chip_smoke.py`` (``FLASH_CASES``
  and ``FLASH_LONG``, bf16, lse from K1): K3a's and K3b-dkv's device
  time (``chip_smoke.Timer``: median of single launches, cold L2) and
  their largest share of ``K3_TOL``.

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
        "__global__ void __launch_bounds__(kMmaThreads, 2)",
        "__global__ void __launch_bounds__(kMmaThreads, D == 64 ? 3 : 2)")],
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
}

_MMA = re.compile(r"flash_bwd_mma_kernelILi(\d+)ELb(\d)E")


def child(build_only: bool):
    """Build this copy's kernels; unless ``build_only``, time K3a and
    K3b-dkv at each timed shape, one JSON line each."""
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
            "k3_limit_share": max(
                max(cs.k3_errors("bfloat16", g, want).values())
                for g in got.values())}), flush=True)


def _ptxas(nvcc, flags, src: Path, obj: Path):
    return subprocess.Popen([nvcc, *flags, "-Xptxas", "-v", "-c", str(src),
                             "-o", str(obj)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def main():
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
        for i, (name, patches) in enumerate(VARIANTS.items()):
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
                    label = m and (f"{'K3a' if m.group(2) == '1' else 'K3b-dkv'}"
                                   f" D {m.group(1)}")
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
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--build-only", action="store_true")
    args = ap.parse_args()
    if args.child:
        child(args.build_only)
    else:
        main()
