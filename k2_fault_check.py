#!/usr/bin/env python3
"""Planted faults in K2's LayerNorm kernels, held to chip_smoke.py's K2 gates.

Run from the root of a checkout on one Hopper card (``nvcc`` and
PyTorch built for CUDA): ``python3 k2_fault_check.py``. For the sound
kernel and then for each fault of ``FAULTS``, it copies
``paddle_tpu_torch/``, ``chip_smoke.py``, ``k1_fault_check.py`` and
itself into a fresh temporary directory, plants the fault in the copy's
``csrc/layer_norm.cu`` (the checkout is never edited), builds that
copy's kernels and runs every K2 case of ``chip_smoke.py``
(``k2_case_inputs``: the timed shapes, rows of large mean, an odd C, an
offset view and wide rows, each with and without w and b) in fp32 and
bf16 through two gates:

- the shared gate: the largest |y - plain| within ``ATOL`` and mean and
  rstd within 2e-5 of the plain version in fp32 (y against the plain
  formula in fp64 at a large mean, where the fp32 plain version is off);
- K2's own gate, ``K2_TOL``: y, mean and rstd element by element
  against the plain formula in fp64.

It prints the card, one JSON line per (kernel, dtype, case) with both
verdicts and the errors they read (for the sound kernel also the atol
that each rtol of ``RTOLS`` would need, per output), and one summary line
per kernel. It exits non-zero if the sound kernel fails a gate, or if a
fault changes some output and K2's gate catches it in no case. Each
output is written once, from one kernel, so a sound run's outputs are
the same from run to run. The copy-plant-run loop is
``k1_fault_check.drive``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

# name -> (source text in csrc/layer_norm.cu, its faulty replacement); the
# warp kernel's, which the timed shapes run
FAULTS = {
    # lane 31's first vector is left out of the sum that sets the mean
    # (the sum of x - m1; the first sum's error is taken out by it)
    "a lane's vector dropped from the sum": (
        "        for (int e = 0; e < N; ++e) s1 += f[e] - m1;\n",
        "        for (int e = 0; e < N; ++e)\n"
        "          s1 += lane == 31 && v == 0 ? 0.f : f[e] - m1;\n"),
    # the variance as E[x^2] - mean^2 in fp32
    "E[x^2] - mean^2 for the variance": (
        "          const float d = (f[e] - m1) - c;\n"
        "          s2 += d * d;\n"
        "        }\n"
        "      }\n"
        "    const float rs = rsqrtf(ptt::warp_sum(s2) / C + eps);\n",
        "          s2 += f[e] * f[e];\n"
        "        }\n"
        "      }\n"
        "    const float mu = m1 + c;\n"
        "    const float rs = rsqrtf(ptt::warp_sum(s2) / C - mu * mu + eps);"
        "\n"),
    # the last warp of every CTA stores no y
    "the last row of a CTA not written": (
        "        yr[lane + 32 * v] = P::store(o);\n",
        "        if (warp != kWarps - 1) yr[lane + 32 * v] = P::store(o);\n"),
    # w read one vector along (the last vector stays put)
    "w off by one vector": (
        "      if (w != nullptr) wv[v] = reinterpret_cast<const uint4*>(w)[i];\n",
        "      if (w != nullptr)\n"
        "        wv[v] = reinterpret_cast<const uint4*>(w)[i + 1 < nv ? i + 1"
        " : i];\n"),
    # b read one vector along
    "b off by one vector": (
        "      if (b != nullptr) bv[v] = reinterpret_cast<const uint4*>(b)[i];\n",
        "      if (b != nullptr)\n"
        "        bv[v] = reinterpret_cast<const uint4*>(b)[i + 1 < nv ? i + 1"
        " : i];\n"),
    # each row's mean lands in the next row's place
    "mean written to the wrong row": (
        "      mean[row] = m1 + c;\n",
        "      mean[(row + 1) % R] = m1 + c;\n"),
    # each row's rstd lands in the next row's place
    "rstd written to the wrong row": (
        "      rstd[row] = rs;\n    }\n  }\n}\n",
        "      rstd[(row + 1) % R] = rs;\n    }\n  }\n}\n"),
}

# for the sound kernel: the atol each rtol would need, per output
RTOLS = {"float32": [0.0, 1e-7, 1e-6], "bfloat16": [2.0 ** -8, 2.0 ** -7],
         "mean": [0.0, 6e-8, 1.2e-7], "rstd": [0.0, 1e-7, 1e-6]}


def child(dtypes, sound_out, sound_in):
    """Every K2 case of this copy's kernels through both gates, one JSON
    line each; the sound run saves its outputs, a fault's run compares
    with them."""
    import torch

    import chip_smoke as cs

    sound = torch.load(sound_in) if sound_in else None
    saved = {}
    for dn in dtypes:
        for case in cs.k2_case_inputs(torch, getattr(torch, dn)):
            outs, plain, exact = cs.k2_run(torch, case)
            err, stat_err, share = cs.k2_errors(dn, case, outs, plain, exact)
            finite = all(cs._finite(t) for out in outs for t in out)
            row = {"dtype": dn, "case": case["shape"], "shared_gate_err": err,
                   "shared_gate_stat_err": stat_err,
                   "shared_gate": finite and err <= cs.ATOL[dn]
                   and stat_err <= 2e-5,
                   "k2_limit_share": share,
                   "k2_gate": finite and share <= 1.0}
            key = f"{dn} {case['shape']}"
            if sound is None:
                saved[key] = [t.cpu() for out in outs for t in out]
                needed = {}
                for what, i in ((dn, 0), ("mean", 1), ("rstd", 2)):
                    for r in RTOLS[what]:
                        needed[f"{what} {r}"] = max(
                            max(0.0, float(((o[i].double() - e[i]).abs()
                                            - r * e[i].abs()).max()))
                            for o, e in zip(outs, exact))
                row["atol_needed"] = needed
            else:
                got = [t.cpu() for out in outs for t in out]
                row["changed"] = not all(
                    torch.equal(a, b) for a, b in zip(got, sound[key]))
            print(json.dumps(row), flush=True)
    if sound_out:
        torch.save(saved, sound_out)


def main():
    import k1_fault_check

    k1_fault_check.drive(Path(__file__).resolve(), "layer_norm.cu", FAULTS,
                         "k2_gate", shared="shared_gate",
                         fault_dtypes=("float32", "bfloat16"))


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
