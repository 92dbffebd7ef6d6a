#!/usr/bin/env python3
"""Planted faults in K3's bf16 dK/dV body, held to chip_smoke.py's K3 gates.

Run from the root of a checkout on one Hopper card (``nvcc`` and
PyTorch built for CUDA): ``python3 k3_fault_check.py``. For the sound
kernel and then for each fault of ``FAULTS``, it copies
``paddle_tpu_torch/``, ``chip_smoke.py``, ``k1_fault_check.py`` and
itself into a fresh temporary directory, plants the fault in the copy's
``csrc/flash_bwd.cu`` (the checkout is never edited), builds that copy's
kernels and runs every K3a and K3b-dkv case of ``chip_smoke.py`` (the
cases of ``k3_case_inputs``, the timed shapes and the long-context
shape, with lse from K1 as in training) against the plain version
through two gates:

- the flash gate: each gradient within ``FLASH_TOL`` relative to
  max(1, max |plain|), the limit every flash kernel is held to;
- K3's own gate, ``K3_TOL``: dQ, dK and dV element by element.

It prints the card, one JSON line per (kernel, case, K3a or K3b-dkv)
with both verdicts and the errors they read (for the sound kernel also
the atol that each rtol of ``RTOLS`` would need, and the run-to-run
spread of the fused dQ over three runs), and one summary line per
kernel. It exits non-zero if the sound kernel fails a gate, or if a
fault changes some output and K3's gate catches it in no case. A fault
changes an output where dK or dV differ from the sound kernel's in any
bit, or dQ by more than its atomics can explain: 4x the sound kernel's
spread plus one unit in the last place of the dtype (a rounding of the
fp32 sum that the atomics' order flips). The copy-plant-run loop is
``k1_fault_check.drive``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

# name -> (source text in csrc/flash_bwd.cu, its faulty replacement)
FAULTS = {
    # every CTA skips the last query tile of its sweep
    "last query tile of the sweep dropped": (
        "  for (int j = 0; j < n_tiles; ++j) {\n"
        "    const int q0 = q_first + j * kTile;\n",
        "  for (int j = 0; j < n_tiles - 1; ++j) {\n"
        "    const int q0 = q_first + j * kTile;\n"),
    # S^T and dK read Q from the ring stage tile j + 1's copies fill
    "Q read from the other ring stage": (
        "    const bf16* qt = qs + st * TILE;\n",
        "    const bf16* qt = qs + (st ^ 1) * TILE;\n"),
    # the top-of-tile barrier, the only one between the dQ pass's reads
    # of the dS tile (and of the ring stage) and their overwrite
    "no barrier before the dS tile is overwritten": (
        "    mma::cp_async_wait<0>();\n    __syncthreads();\n"
        "    if (j + 1 < n_tiles) stage_tile(j + 1);\n",
        "    mma::cp_async_wait<0>();\n"
        "    if (j + 1 < n_tiles) stage_tile(j + 1);\n"),
    # the dQ pass reads the dS tile before every warp stored its rows
    "dS tile read before every warp stored it": (
        "      // every warp's dS^T rows are in the tile\n"
        "      __syncthreads();\n",
        "      // every warp's dS^T rows are in the tile\n"),
    # zero-filled queries past Sq keep p = exp(0 - 0) = 1
    "queries past Sq not masked": (
        "            if (row >= a.Sq || key >= a.Sk || (a.causal && row < key))"
        "\n",
        "            if (key >= a.Sk || (a.causal && row < key))\n"),
    # the causal mask hides the diagonal, each row's own key
    "diagonal key masked": (
        "            if (row >= a.Sq || key >= a.Sk || (a.causal && row < key))"
        "\n",
        "            if (row >= a.Sq || key >= a.Sk || (a.causal && row <= key))"
        "\n"),
    # the last warp's 16 queries of each tile never reach dQ
    "one warp's dQ atomics skipped": (
        "          if (row >= a.Sq) continue;\n          float* dqr = dq_acc +",
        "          if (row >= a.Sq || warp == 3) continue;\n"
        "          float* dqr = dq_acc +"),
}

# for the sound kernel: the atol each rtol would need, per gradient
RTOLS = {"bfloat16": [0.0, 2.0 ** -8, 2.0 ** -7, 1e-2],
         "float32": [0.0, 1e-6, 1e-5]}
# one unit in the last place of the dtype, relative to the value (at
# most 2**-7 in bf16, 2**-22 in fp32): where dQ moves by no more (beyond
# its spread), the atomics' order explains it and the fault did not
# change it
EPS = {"bfloat16": 2.0 ** -7, "float32": 2.0 ** -22}


def _cases(torch, cs, dtype):
    yield from cs.k3_case_inputs(torch, dtype)
    for ci, (B, S, H, D, causal) in enumerate(cs.FLASH_CASES):
        yield (f"timed {[B, S, H, D, causal]}",
               cs._flash_inputs(torch, B, S, H, D, dtype, 41 + ci), causal)
    B, S, H, D, causal = cs.FLASH_LONG
    yield (f"long-context {[B, S, H, D, causal]}",
           cs._flash_inputs(torch, B, S, H, D, dtype, 47), causal)


def child(dtypes, sound_out, sound_in):
    """Every K3 case of this copy's kernel through both gates, one JSON
    line per (case, kernel); the sound run saves its outputs and dQ's
    spread, a fault's run compares with them."""
    import torch

    import chip_smoke as cs

    # the plain version's products in full fp32, as in chip_smoke.py
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sound = torch.load(sound_in) if sound_in else None
    saved = {}
    for dn in dtypes:
        for name, (q, k, v, do), causal in _cases(torch, cs,
                                                  getattr(torch, dn)):
            want, got, _ = cs.k3_grads(torch, q, k, v, do, causal)
            spread = 0.0
            if sound is None:    # the fused dQ's atomics, run to run
                for _ in range(2):
                    again = cs.k3_grads(torch, q, k, v, do, causal)[1]
                    spread = max(spread, cs._err(again["K3a"][0],
                                                 got["K3a"][0]))
            for kid, grads in got.items():
                names = ("dQ", "dK", "dV")[3 - len(grads):]
                plain = want[3 - len(grads):]
                finite = all(bool(torch.isfinite(g.float()).all())
                             for g in grads)
                rel = max(cs._rel_err(g, w) for g, w in zip(grads, plain))
                shares = cs.k3_errors(dn, grads, want)
                row = {"dtype": dn, "case": name, "k3": kid,
                       "flash_gate_rel_err": rel,
                       "flash_gate": finite and rel <= cs.FLASH_TOL[dn],
                       "k3_limit_shares": shares,
                       "k3_gate": finite and cs.k3_passes(dn, grads, want)}
                key = f"{dn} {name} {kid}"
                if sound is None:
                    saved[key] = ([g.cpu() for g in grads], spread)
                    row["dq_spread"] = spread
                    row["atol_needed"] = {}
                    for n, g, w in zip(names, grads, plain):
                        err, mag = (g.float() - w.float()).abs(), \
                            w.float().abs()
                        row["atol_needed"][n] = {
                            str(r): max(0.0, float((err - r * mag).max()))
                            for r in RTOLS[dn]}
                else:
                    ref, spread = sound[key]
                    moved = []
                    for n, g, r in zip(names, grads, ref):
                        g, r = g.cpu().float(), r.float()
                        if n == "dQ":
                            lim = 4 * spread + EPS[dn] * r.abs()
                            moved.append(not bool(((g - r).abs()
                                                   <= lim).all()))
                        else:
                            moved.append(not torch.equal(g, r))
                    row["changed"] = any(moved)
                print(json.dumps(row), flush=True)
    if sound_out:
        torch.save(saved, sound_out)


def main():
    import k1_fault_check

    k1_fault_check.drive(Path(__file__).resolve(), "flash_bwd.cu", FAULTS,
                         "k3_gate")


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
