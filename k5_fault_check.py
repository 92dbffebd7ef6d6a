#!/usr/bin/env python3
"""Planted faults in K5's bf16/fp16 body, held to chip_smoke.py's K5 gates.

Run from the root of a checkout on one Hopper card (``nvcc`` and
PyTorch built for CUDA): ``python3 k5_fault_check.py``. For the sound
kernel and then for each fault of ``FAULTS``, it copies
``paddle_tpu_torch/``, ``chip_smoke.py``, ``k1_fault_check.py`` and
itself into a fresh temporary directory, plants the fault in the copy's
``csrc/chunk_prefill.cu`` (the checkout is never edited), builds that
copy's kernels and runs every bf16 and fp16 K5 and K5-int8 case of
``chip_smoke.py`` (``k5_case_inputs``: the five chunk shapes over pools
of q's dtype, the two over int8 pools, three slots at their own starts over
each; clean, poisoned and NaN-poisoned pools) against the plain version
through two gates:

- the shared gate, ``ATOL``: the largest |kernel - plain| over clean,
  poisoned and NaN-poisoned pools (over int8 pools relative to max(1,
  max |plain|)), the limit every K4/K5 case is held to;
- K5's own gate, ``K5_TOL`` (bf16 and fp16 each their own limits):
  element by element against the plain version in fp32.

It prints the card, one JSON line per (kernel, case) with both verdicts
and the errors they read (for the sound kernel also the atol that each
rtol of ``RTOLS`` would need), and one summary line per kernel. It exits
non-zero if the sound kernel fails a gate, or if a fault changes some
output and K5's gate catches it in no case. A fault changes an output
where any of the three differs from the sound kernel's in any bit (the
body has no atomics: its outputs are the same from run to run). fp32 q
runs K4's body, which no fault here touches, so only bf16 and fp16 q
are run (one source, two instantiations). The
copy-plant-run loop is ``k1_fault_check.drive``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

# name -> (source text in csrc/chunk_prefill.cu, its faulty replacement)
FAULTS = {
    # every warp skips the second key tile of its sweep
    "a key tile dropped": (
        "    if (!warp_live || j0 > wbase + 15) continue;\n",
        "    if (!warp_live || j0 > wbase + 15 || j == 1) continue;\n"),
    # each key row is read from the block the next table entry names
    "the next table entry's block read": (
        "(static_cast<int64_t>(trow[cl / bs]) * bs + cl % bs) * rs",
        "(static_cast<int64_t>(trow[min(cl / bs + 1, bp - 1)]) * bs + "
        "cl % bs) * rs"),
    # a row reads the chunk's keys past its own position
    "the diagonal mask off": (
        "          if (col > pos || col > reach) x = ptt::kMaskedLogit;\n",
        "          if (col > reach) x = ptt::kMaskedLogit;\n"),
    # zero-filled keys past the table's end get logit 0, not the mask
    "the reach mask off": (
        "          if (col > pos || col > reach) x = ptt::kMaskedLogit;\n",
        "          if (col > pos) x = ptt::kMaskedLogit;\n"),
    # the k scale of the block the next table entry names
    "the wrong block's k scale": (
        "ksc + st * kKeys + r, ksp + at,",
        "ksc + st * kKeys + r, ksp + static_cast<int64_t>("
        "trow[min(cl / bs + 1, bp - 1)]) * H + h,"),
    # the v scale of the block the next table entry names
    "the wrong block's v scale": (
        "vsc + st * kKeys + r, vsp + at,",
        "vsc + st * kKeys + r, vsp + static_cast<int64_t>("
        "trow[min(cl / bs + 1, bp - 1)]) * H + h,"),
    # tile j's copies may still be in flight during its math
    "the ring not waited for": (
        "    mma::cp_async_wait<kStages - 2>();\n",
        "    mma::cp_async_wait<kStages - 1>();\n"),
    # the last warp's 16 rows of each tile are never stored
    "one warp's store skipped": (
        "    if (row < s && c * 8 < dh)\n      *reinterpret_cast<uint4*>(oh",
        "    if (row < s && c * 8 < dh && warp != 3)\n"
        "      *reinterpret_cast<uint4*>(oh"),
}

# for the sound kernel: the atol each rtol would need
RTOLS = [0.0, 2.0 ** -10, 2.0 ** -9, 2.0 ** -8, 2.0 ** -7, 1e-2]


def child(dtypes, sound_out, sound_in):
    """Every bf16 and fp16 K5 case of this copy's kernel (of ``dtypes``,
    those two) through both gates, one JSON line each; the sound run saves
    its outputs, a fault's run compares with them. fp32 q runs the
    CUDA-core body, which no fault here touches, so fp32 is not run."""
    import torch

    import chip_smoke as cs

    # the plain version's products in full fp32, as in chip_smoke.py
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sound = torch.load(sound_in) if sound_in else None
    saved = {}
    for dn, int8 in ((dn, int8) for dn in dtypes if dn != "float32"
                     for int8 in (False, True)):
        for case in cs.k5_case_inputs(torch, getattr(torch, dn), int8):
            outs, shared, exact = cs.k5_run(torch, case)
            finite = all(cs._finite(o) for o in outs)
            err, rel = cs.paged_shared_error(dn, int8, outs, shared)
            share = cs.k5_share(int8, outs, exact, dn)
            pools = "int8" if int8 else dn
            row = {"dtype": dn, "pools": pools,
                   "case": case["shape"], "shared_gate_err": rel,
                   "shared_gate": finite and rel <= cs.ATOL[dn],
                   "k5_limit_share": share,
                   "k5_gate": finite and share <= 1.0}
            key = f"{dn} {pools} {case['shape']}"
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

    k1_fault_check.drive(Path(__file__).resolve(), "chunk_prefill.cu",
                         FAULTS, "k5_gate", shared="shared_gate",
                         fault_dtypes=("bfloat16", "float16"))


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
