#!/usr/bin/env python3
"""Planted faults in K4's and K5's fp32 body, held to chip_smoke.py's gates.

Run from the root of a checkout on one Hopper card (``nvcc`` and
PyTorch built for CUDA): ``python3 k45_f32_fault_check.py``. For the
sound kernel and then for each fault of ``FAULTS``, it copies
``paddle_tpu_torch/``, ``chip_smoke.py``, ``k1_fault_check.py`` and
itself into a fresh temporary directory, plants the fault in the copy's
``csrc/paged_common.cuh`` (the checkout is never edited), builds that
copy's kernels and runs every fp32-q K4 and K5 case of ``chip_smoke.py``
(``k4_case_inputs``: the decode step of 8 slots, a lone request at t
1000, a verify of 4 drafts, slots running off tables of 5 blocks of 16
rows and of 3 blocks of 11; ``k5_case_inputs``: chunks at starts 0,
128, 517, a chunk of 100 at 300, one of 64 at 1000 and one running off a
table of 5 blocks; over fp32 and int8 pools, clean, poisoned and
NaN-poisoned) against the plain version through two gates:

- the shared gate, ``ATOL``: the largest |kernel - plain| over clean,
  poisoned and NaN-poisoned pools;
- the body's own gate, ``F32_PAGED_TOL``: element by element.

It prints the card, one JSON line per (kernel, case) with both verdicts
and the errors they read (for the sound kernel also the atol that each
rtol of ``RTOLS`` would need), and one summary line per kernel. It exits
non-zero if the sound kernel fails a gate, or if a fault changes some
output and the body's gate catches it in no case. The body has no
atomics, so its outputs are the same from run to run: a fault changes an
output where any of the three differs from the sound kernel's in any
bit. bf16 q runs other bodies, so only fp32 q is run. The
copy-plant-run loop is ``k1_fault_check.drive``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

_NEXT_BLOCK = "static_cast<int64_t>(trow[min(cl / bs + 1, bp - 1)])"

# name -> (source text in csrc/paged_common.cuh, its faulty replacement)
FAULTS = {
    # every rank skips its second key tile (its logits masked)
    "a key tile dropped": (
        "          if (col > pos || col > reach) sc[r][c] = kMaskedLogit;\n",
        "          if (col > pos || col > reach || j == tile_lo + 1)\n"
        "            sc[r][c] = kMaskedLogit;\n"),
    # the cluster merge sums every rank's partial but the last
    "one rank's partial left out of the merge": (
        "      if (r < nsplit) {\n"
        "        const float a = exp2f(mr[r] - mm);\n",
        "      if (r < nsplit - 1) {\n"
        "        const float a = exp2f(mr[r] - mm);\n"),
    # a row reads the keys its later rows may read
    "the row mask off": (
        "          if (col > pos || col > reach) sc[r][c] = kMaskedLogit;\n",
        "          if (col > reach) sc[r][c] = kMaskedLogit;\n"),
    # zero-filled keys past the table's end get logit 0, not the mask
    "the reach mask off": (
        "          if (col > pos || col > reach) sc[r][c] = kMaskedLogit;\n",
        "          if (col > pos) sc[r][c] = kMaskedLogit;\n"),
    # the k scale of the block the next table entry names
    "the wrong block's k scale": (
        "          mma::cp_async_4(ksd + r, ksp + at, col <= reach);\n",
        f"          mma::cp_async_4(ksd + r, ksp + {_NEXT_BLOCK} * H + h,\n"
        "                          col <= reach);\n"),
    # the v scale of the block the next table entry names
    "the wrong block's v scale": (
        "          mma::cp_async_4(vsd + r, vsp + at, col <= reach);\n",
        f"          mma::cp_async_4(vsd + r, vsp + {_NEXT_BLOCK} * H + h,\n"
        "                          col <= reach);\n"),
    # every row tile computes with the q rows of the chunk's first tile
    "the row tile mapped to the wrong q rows": (
        "      qs[i * KP + d] = i < nrows ? q[(q_row0 + i) * rs + h * D + d] * "
        "sl : 0.f;\n",
        "      qs[i * KP + d] =\n"
        "          i < nrows ? q[(q_row0 - row0 + i) * rs + h * D + d] * sl : "
        "0.f;\n"),
}

# for the sound kernel: the atol each rtol would need
RTOLS = [0.0, 1e-6, 1e-5]


def cases(torch, cs):
    for int8 in (False, True):
        for case in cs.k4_case_inputs(torch, torch.float32, int8):
            yield "K4", case, cs.k4_run
        for case in cs.k5_case_inputs(torch, torch.float32, int8):
            yield "K5", case, cs.k5_run


def child(dtypes, sound_out, sound_in):
    """Every fp32-q K4 and K5 case of this copy's kernels through both
    gates, one JSON line each; the sound run saves its outputs, a fault's
    run compares with them. ``dtypes`` is taken for drive()'s sake: the
    body runs fp32 q only."""
    import torch

    import chip_smoke as cs

    # the plain version's products in full fp32, as in chip_smoke.py
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sound = torch.load(sound_in) if sound_in else None
    saved = {}
    for kid, case, run in cases(torch, cs):
        int8 = case["int8"]
        outs, shared, exact = run(torch, case)
        finite = all(cs._finite(o) for o in outs)
        err, rel = cs.paged_shared_error("float32", int8, outs, shared)
        share = cs.f32_share(int8, outs, exact)
        pools = "int8" if int8 else "fp32"
        row = {"kernel_id": kid, "dtype": "float32", "pools": pools,
               "case": case["shape"], "shared_gate_err": rel,
               "shared_gate": finite and rel <= cs.ATOL["float32"],
               "f32_limit_share": share, "f32_gate": finite and share <= 1.0}
        key = f"{kid} {pools} {case['shape']}"
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
                torch.equal(o.cpu(), so) for o, so in zip(outs, sound[key]))
        print(json.dumps(row), flush=True)
    if sound_out:
        torch.save(saved, sound_out)


def main():
    import k1_fault_check

    k1_fault_check.drive(Path(__file__).resolve(), "paged_common.cuh",
                         FAULTS, "f32_gate", shared="shared_gate",
                         fault_dtypes=("float32",))


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
