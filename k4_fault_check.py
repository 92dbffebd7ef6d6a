#!/usr/bin/env python3
"""Planted faults in K4's bf16 cluster body, held to chip_smoke.py's K4 gates.

Run from the root of a checkout on one Hopper card (``nvcc`` and
PyTorch built for CUDA): ``python3 k4_fault_check.py``. For the sound
kernel and then for each fault of ``FAULTS``, it copies
``paddle_tpu_torch/``, ``chip_smoke.py``, ``k1_fault_check.py`` and
itself into a fresh temporary directory, plants the fault in the copy's
``csrc/paged_attention.cu`` (the checkout is never edited), builds that
copy's kernels and runs every bf16 K4 and K4-int8 case of
``chip_smoke.py`` (``k4_case_inputs``: the decode step of 8 slots, a
lone request at t 1000, a verify of 4 drafts, a slot running off a
table of 5 blocks of 16 rows and 16 rows running off one of 3 blocks of
11, over bf16 pools and over int8 pools; clean, poisoned and
NaN-poisoned pools) against the plain version through two gates:

- the shared gate, ``ATOL``: the largest |kernel - plain| over clean,
  poisoned and NaN-poisoned pools (over int8 pools relative to max(1,
  max |plain|)), the limit every K4/K5 case is held to;
- K4's own gate, ``K4_TOL``: element by element against the plain
  version in fp32.

It prints the card, one JSON line per (kernel, case) with both verdicts
and the errors they read (for the sound kernel also the atol that each
rtol of ``RTOLS`` would need), and one summary line per kernel. It exits
non-zero if the sound kernel fails a gate, or if a fault changes some
output and K4's gate catches it in no case. A fault changes an output
where any of the three differs from the sound kernel's in any bit (the
body has no atomics: its outputs are the same from run to run); a race
that leaves every output as it was escapes both gates and is reported
as unchanged. A fault whose run fails on the card (a CTA's shared
memory read after it exited may fault) is reported as caught by the
run. fp32 q runs the CUDA-core body, which no fault here touches, so
only bf16 q is run. The copy-plant-run loop is ``k1_fault_check.drive``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

_NEXT_BLOCK = "static_cast<int64_t>(trow[min(cl / bs + 1, bp - 1)])"

# name -> (source text in csrc/paged_attention.cu, its faulty replacement)
FAULTS = {
    # every warp skips its second slice: the rank's second key tile
    "a key tile dropped": (
        "    float sc[NS][4];\n",
        "    if (u == 1) continue;\n    float sc[NS][4];\n"),
    # each key row is read from the block the next table entry names
    "the next table entry's block read": (
        "(static_cast<int64_t>(trow[cl / bs]) * bs + cl % bs) * rs",
        f"({_NEXT_BLOCK} * bs + cl % bs) * rs"),
    # a row reads the keys its later rows may read
    "the row mask off": (
        "          if (col > pos || col > reach) x = ptt::kMaskedLogit;\n",
        "          if (col > reach) x = ptt::kMaskedLogit;\n"),
    # zero-filled keys past the table's end get logit 0, not the mask
    "the reach mask off": (
        "          if (col > pos || col > reach) x = ptt::kMaskedLogit;\n",
        "          if (col > pos) x = ptt::kMaskedLogit;\n"),
    # the k scale of the block the next table entry names
    "the wrong block's k scale": (
        "mma::cp_async_4(ksc + st * kWarpKeys + r, ksp + at, col <= reach);",
        "mma::cp_async_4(ksc + st * kWarpKeys + r, ksp + "
        f"{_NEXT_BLOCK} * H + h, col <= reach);"),
    # the v scale of the block the next table entry names
    "the wrong block's v scale": (
        "mma::cp_async_4(vsc + st * kWarpKeys + r, vsp + at, col <= reach);",
        "mma::cp_async_4(vsc + st * kWarpKeys + r, vsp + "
        f"{_NEXT_BLOCK} * H + h, col <= reach);"),
    # a warp's o is added in the unit of its own last fv
    "a split's fv not undone in the merge": (
        "make_float2(o[n][2 * i] * f, o[n][2 * i + 1] * f);",
        "make_float2(o[n][2 * i], o[n][2 * i + 1]);"),
    # the cluster merge sums every rank's partial but the last
    "one rank's partial left out of the merge": (
        "    for (int r = 0; r < kSplits; ++r) {\n"
        "      const float a = exp2f(mr[r] - mm);\n",
        "    for (int r = 0; r < kSplits - 1; ++r) {\n"
        "      const float a = exp2f(mr[r] - mm);\n"),
    # a CTA may exit while another still reads its shared memory
    "the second cluster.sync() removed": (
        "  // no CTA leaves while another still reads its shared memory\n"
        "  cluster.sync();\n",
        ""),
    # slice u's copies may still be in flight during its math
    "the ring not waited for": (
        "    mma::cp_async_wait<kStages - 2>();\n",
        "    mma::cp_async_wait<kStages - 1>();\n"),
}

# for the sound kernel: the atol each rtol would need
RTOLS = [0.0, 2.0 ** -8, 2.0 ** -7, 1e-2]


def child(dtypes, sound_out, sound_in):
    """Every bf16 K4 case of this copy's kernel through both gates, one
    JSON line each; the sound run saves its outputs, a fault's run
    compares with them. ``dtypes`` is taken for drive()'s sake: fp32 q
    runs the CUDA-core body, so the cases are bf16 only."""
    import torch

    import chip_smoke as cs

    # the plain version's products in full fp32, as in chip_smoke.py
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sound = torch.load(sound_in) if sound_in else None
    saved = {}
    for int8 in (False, True):
        for case in cs.k4_case_inputs(torch, torch.bfloat16, int8):
            outs, shared, exact = cs.k4_run(torch, case)
            finite = all(cs._finite(o) for o in outs)
            err, rel = cs.paged_shared_error("bfloat16", int8, outs, shared)
            share = cs.k4_share(int8, outs, exact)
            pools = "int8" if int8 else "bf16"
            row = {"dtype": "bfloat16", "pools": pools,
                   "case": case["shape"], "shared_gate_err": rel,
                   "shared_gate": finite and rel <= cs.ATOL["bfloat16"],
                   "k4_limit_share": share,
                   "k4_gate": finite and share <= 1.0}
            key = f"{pools} {case['shape']}"
            if sound is None:
                saved[key] = [o.cpu() for o in outs]
                needed = {str(r): 0.0 for r in RTOLS}
                for out, ref in zip(outs, (exact[0], exact[1], exact[0])):
                    e = (out.float() - ref.float()).abs()
                    for r in RTOLS:
                        needed[str(r)] = max(needed[str(r)], float(
                            (e - r * ref.float().abs()).max()))
                row["atol_needed"] = needed
            else:
                row["changed"] = not all(
                    torch.equal(o.cpu(), so) for o, so in zip(outs,
                                                              sound[key]))
            print(json.dumps(row), flush=True)
    if sound_out:
        torch.save(saved, sound_out)


def main():
    import k1_fault_check

    k1_fault_check.drive(Path(__file__).resolve(), "paged_attention.cu",
                         FAULTS, "k4_gate", shared="shared_gate",
                         may_fault={"the second cluster.sync() removed"})


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--dtypes", nargs="+", default=[])
    ap.add_argument("--sound-out")
    ap.add_argument("--sound-in")
    args = ap.parse_args()
    if args.child:
        child(args.dtypes, args.sound_out, args.sound_in)
    else:
        main()
