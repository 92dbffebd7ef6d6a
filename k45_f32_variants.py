#!/usr/bin/env python3
"""Design variants of K4's and K5's fp32 body, timed side by side on one card.

Run from the root of a checkout on one Hopper card (``nvcc`` and
PyTorch built for CUDA): ``python3 k45_f32_variants.py [--parent DIR]
[NAME ...]`` (the named variants of ``VARIANTS``, by default all). Each
variant is a set
of text patches on ``csrc/paged_common.cuh`` (and, where the design
needs it, on the two C entries' sources): the body as built (its own row
tile, the key walk split across a cluster of the size ``f32_splits``
picks from the grid, register-tiled products), and the choices its
design rejected: a fixed cluster size of 1 (no split), 2, 4 or 8; the
row tile (K4's and K5's, ``f32_rows``) fixed at 16, 32 or 64 rows; each
thread's logits and outputs taken one dot product at a time, every
operand read from shared memory (no micro-tiling). With ``--parent DIR``, a checkout of an earlier
commit (``git archive <commit> | tar -x -C DIR``), that commit's
``paged_common.cuh``, ``paged_attention.cu`` and ``chunk_prefill.cu``
are one more variant, "parent". For each one it copies the
port into a fresh temporary directory and patches the copy (the
checkout is never edited), builds every copy at once, then prints per
variant

- ``nvcc -Xptxas -v``'s registers and spills of each instantiation of
  ``paged_f32_kernel<TP, D, RT>`` in ``chunk_prefill.cu``;
- one JSON line per fp32-q K4 and K5 case of ``chip_smoke.py``
  (``k4_case_inputs``, ``k5_case_inputs``; fp32 and int8 pools): the
  device time (``chip_smoke.Timer``: median of single launches, cold L2)
  and the largest share of ``F32_PAGED_TOL``.

The variants run one after another in one process each, so their times
compare within the call. It exits non-zero if a variant's run fails or
breaks F32_PAGED_TOL. The loop is ``k2_variants.run``.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _csrc(name):
    return (ROOT / "paddle_tpu_torch" / "csrc" / name).read_text()


def _between(name, start, end):
    """The text of ``csrc/<name>`` (the checkout's) from ``start`` up to
    ``end``."""
    src = _csrc(name)
    i = src.index(start)
    return src[i:src.index(end, i)]


def _splits(c):
    return [("  int c = kF32MaxSplits;\n"
             "  while (c > 1 && (units * c > target || c > max_tiles)) c /= 2;\n"
             "  return c;\n",
             f"  (void)units;\n  (void)target;\n  (void)max_tiles;\n"
             f"  return {c};\n")]


def _rows(rt):
    return [("inline int f32_rows(int s) { return s <= 16 ? 16 : s <= 32 ? "
             "32 : 64; }",
             f"inline int f32_rows(int) {{ return {rt}; }}")]


_QK = ("      // a row a thread: half the loads in flight",
       "      // the masks and the online softmax")
_PV = ("      // O += P.V: four keys a step\n",
       "    if constexpr (!kCode) {\n      __syncthreads();  // every thread")

# each logit and each output float4 by its own loop over shared memory
_NO_MICRO = [
    (lambda: _between("paged_common.cuh", *_QK),
     "#pragma unroll\n"
     "      for (int r = 0; r < MR; ++r)\n"
     "#pragma unroll\n"
     "        for (int c = 0; c < MC; ++c) {\n"
     "          const float4* qr = reinterpret_cast<const float4*>(\n"
     "              qs + (grp + kF32Groups * r) * KP);\n"
     "          const float4* kr = reinterpret_cast<const float4*>(\n"
     "              kt + (lane + kF32Lanes * c) * KP);\n"
     "          float a = 0.f;\n"
     "#pragma unroll 4\n"
     "          for (int x = 0; x < D / 4; ++x) {\n"
     "            const float4 qv = qr[x], kv = kr[x];\n"
     "            a = fmaf(qv.x, kv.x, a);\n"
     "            a = fmaf(qv.y, kv.y, a);\n"
     "            a = fmaf(qv.z, kv.z, a);\n"
     "            a = fmaf(qv.w, kv.w, a);\n"
     "          }\n"
     "          sc[r][c] = a;\n"
     "        }\n"),
    (lambda: _between("paged_common.cuh", *_PV),
     "#pragma unroll\n"
     "      for (int r = 0; r < MR; ++r)\n"
     "#pragma unroll\n"
     "        for (int x = 0; x < MD; ++x) {\n"
     "          const float* pr = ps + (grp + kF32Groups * r) * PP;\n"
     "          const float* vc = vt + 4 * lane + 64 * x;\n"
     "#pragma unroll 4\n"
     "          for (int c = 0; c < KT; ++c) {\n"
     "            const float p = pr[c];\n"
     "            const float4 v = *reinterpret_cast<const float4*>(vc + c * D);"
     "\n"
     "            acc[r][x][0] = fmaf(p, v.x, acc[r][x][0]);\n"
     "            acc[r][x][1] = fmaf(p, v.y, acc[r][x][1]);\n"
     "            acc[r][x][2] = fmaf(p, v.z, acc[r][x][2]);\n"
     "            acc[r][x][3] = fmaf(p, v.w, acc[r][x][3]);\n"
     "          }\n"
     "        }\n"
     "    }\n"),
]

# name -> [(text in csrc/paged_common.cuh, or a callable giving it,
# replacement), or (file under paddle_tpu_torch/, text, replacement)]
VARIANTS = {
    "as built": [],
    "C = 1 (no split)": _splits(1),
    "C = 2": _splits(2),
    "C = 4": _splits(4),
    "C = 8": _splits(8),
    "row tile 16": _rows(16),
    "row tile 32": _rows(32),
    "row tile 64": _rows(64),
    "no micro-tiling": _NO_MICRO,
}

_KERNEL = re.compile(r"(paged_f32_kernel|paged_attn_kernel)I(f|a)"
                     r"(?:f|a)?Li(\d+)ELi(\d+)E")


def _label(m):
    if m.group(1) == "paged_attn_kernel":  # the parent's body, PRs 1-9
        return f"paged_attn_kernel, D {m.group(3)}"
    return (f"pool {'int8' if m.group(2) == 'a' else 'fp32'}, D {m.group(3)}"
            f", {m.group(4)}-row tiles")


def child(build_only: bool):
    """Build this copy's kernels; unless ``build_only``, time every
    fp32-q K4 and K5 case, one JSON line each."""
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import chunk_prefill as k5
    from paddle_tpu_torch.ops.kernels import paged_attention as k4

    _build.load_library()
    if build_only:
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    timer = cs.Timer(torch)
    bad = False
    for int8 in (False, True):
        for kid, cases, run, fn in (
                ("K4", cs.k4_case_inputs, cs.k4_run, k4.paged_attention),
                ("K5", cs.k5_case_inputs, cs.k5_run, k5.chunk_prefill)):
            for case in cases(torch, torch.float32, int8):
                outs, _, exact = run(torch, case)
                share = cs.f32_share(int8, outs, exact)
                q, table_t, t = case["q"], case["table_t"], case["t"]
                (kc, vc), sc = (case["pools"] if int8
                                else (case["pools"], (None, None)))
                ms = timer(lambda: fn(q, kc, vc, table_t, t, k_scale=sc[0],
                                      v_scale=sc[1]))
                bad |= not share <= 1.0
                print(json.dumps({"kernel_id": kid,
                                  "pools": "int8" if int8 else "fp32",
                                  "case": case["shape"], "kernel_ms": ms,
                                  "f32_limit_share": share}), flush=True)
    if bad:
        sys.exit("a case breaks F32_PAGED_TOL")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", help="variants to run (default all)")
    ap.add_argument("--parent", help="an earlier commit's checkout, whose "
                    "body is timed as the variant 'parent'")
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--build-only", action="store_true")
    args = ap.parse_args()
    if args.child:
        child(args.build_only)
    else:
        import k2_variants

        if args.parent:
            VARIANTS["parent"] = k2_variants.parent_files(
                args.parent, ["paged_common.cuh", "paged_attention.cu",
                              "chunk_prefill.cu"])
        k2_variants.run(Path(__file__).resolve(), "paged_common.cuh",
                        VARIANTS, args.names, _KERNEL, _label,
                        ptxas_source="chunk_prefill.cu")
