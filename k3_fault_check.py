#!/usr/bin/env python3
"""Planted faults in K3's tensor-core bodies, held to chip_smoke.py's K3 gates.

Run from the root of a checkout on one Hopper card (``nvcc`` and
PyTorch built for CUDA): ``python3 k3_fault_check.py``. For the sound
kernel and then for each fault of ``FAULTS`` (in the dK/dV body, K3a and
K3b-dkv, or in the dQ body, K3b-dq), it copies ``paddle_tpu_torch/``,
``chip_smoke.py``, ``k1_fault_check.py`` and itself into a fresh
temporary directory, plants the fault in the copy's
``csrc/flash_bwd.cu`` (the checkout is never edited), builds that copy's
kernels and runs every K3a, K3b-dkv and K3b-dq case of
``chip_smoke.py`` (the cases of ``k3_case_inputs``, the timed shapes of
``FLASH_TIMED`` and the long-context shape, with lse from K1 as in
training, and the long-context route through the public sdpa's
backward, lse and delta from its own forward) against the plain version
through two gates. The sound kernel
runs in fp32, bf16 and fp16, each fault in bf16 and fp16 (one source
instantiated on both types). The gates:

- the flash gate: each gradient within ``FLASH_TOL`` relative to
  max(1, max |plain|), the limit every flash kernel is held to;
- K3's own gate, ``K3_TOL``: dQ, dK and dV element by element.

It prints the card, one JSON line per (kernel, case, K3 kernel) with
both verdicts and the errors they read (for the sound kernel also the
atol that each rtol of ``RTOLS`` would need, and the run-to-run spread
of each output over three runs), and one summary line per kernel. It exits
non-zero if the sound kernel fails a gate, or if a fault changes some
output and K3's gate catches it in no case. A fault changes an output
where dK, dV or K3b-dq's dQ (written once, no atomics) differ from the
sound kernel's in any bit beyond 4x their spread, or K3a's dQ by more
than its atomics can explain: 4x the sound kernel's spread plus one
unit in the last place of the dtype (a rounding of the fp32 sum that
the atomics' order flips). The copy-plant-run loop is
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
        "    const T* qt = qs + st * TILE;\n",
        "    const T* qt = qs + (st ^ 1) * TILE;\n"),
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
    # the dQ body (K3b-dq): every CTA skips the last key tile of its
    # sweep, the causal diagonal
    "dQ: diagonal key tile dropped": (
        "  for (int j = 0; j < n_tiles; ++j) {\n"
        "    const int k0 = j * kTile, st = j & 1;\n",
        "  for (int j = 0; j < n_tiles - 1; ++j) {\n"
        "    const int k0 = j * kTile, st = j & 1;\n"),
    # S and dS K read K from the stage tile j + 1's copies fill
    "dQ: K read from the other ring stage": (
        "    const T* kt = ks + st * TILE;\n",
        "    const T* kt = ks + (st ^ 1) * TILE;\n"),
    # tile j's K and V copies may still be in flight during its math
    "dQ: key tile not waited for": (
        "    mma::cp_async_wait<0>();\n    __syncthreads();\n"
        "    if (j + 1 < n_tiles) stage_kv(j + 1);\n",
        "    mma::cp_async_wait<1>();\n    __syncthreads();\n"
        "    if (j + 1 < n_tiles) stage_kv(j + 1);\n"),
    # no barrier between a stage's last read and the copies refilling it
    "dQ: no barrier before the ring's refill": (
        "    mma::cp_async_wait<0>();\n    __syncthreads();\n"
        "    if (j + 1 < n_tiles) stage_kv(j + 1);\n",
        "    mma::cp_async_wait<0>();\n"
        "    if (j + 1 < n_tiles) stage_kv(j + 1);\n"),
    # the causal mask hides the diagonal, each row's own key
    "dQ: diagonal key masked": (
        "            if (key >= a.Sk || (a.causal && row < key)) p = 0.f;\n",
        "            if (key >= a.Sk || (a.causal && row <= key)) p = 0.f;\n"),
    # zero-filled keys past Sk keep p = exp(0 - lse), but meet K = 0 in
    # dS K
    "dQ: keys past Sk not masked": (
        "            if (key >= a.Sk || (a.causal && row < key)) p = 0.f;\n",
        "            if (a.causal && row < key) p = 0.f;\n"),
    # the last warp's 16 dQ rows are never stored
    "dQ: one warp's store skipped": (
        "    const int row = w0 + g + 8 * i;\n    if (row >= a.Sq) continue;\n",
        "    const int row = w0 + g + 8 * i;\n"
        "    if (row >= a.Sq || warp == 3) continue;\n"),
}

# for the sound kernel: the atol each rtol would need, per gradient
RTOLS = {"bfloat16": [0.0, 2.0 ** -8, 2.0 ** -7, 1e-2],
         "float16": [0.0, 2.0 ** -11, 2.0 ** -10, 2.0 ** -9, 1e-2],
         "float32": [0.0, 1e-6, 1e-5]}
# one unit in the last place of the dtype, relative to the value (at
# most 2**-7 in bf16, 2**-10 in fp16, 2**-22 in fp32): where dQ moves
# by no more (beyond its spread), the atomics' order explains it and the
# fault did not change it
EPS = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10, "float32": 2.0 ** -22}


def _cases(torch, cs, dtype):
    """(name, (q, k, v, dO), causal, gate, grads) of every K3 case of
    ``dtype``: ``grads`` is ``chip_smoke.k3_grads`` (each kernel called
    on K1's lse and the plain O's delta), or for the long-context route
    ``k3_route_grads`` (the public sdpa's backward), as chip_smoke.py
    checks each."""
    dn = str(dtype).split(".")[1]
    for name, inputs, causal in cs.k3_case_inputs(torch, dtype):
        yield name, inputs, causal, dn, cs.k3_grads
    for ci, (B, S, H, D, causal) in enumerate(cs.FLASH_TIMED[dn]):
        yield (f"timed {[B, S, H, D, causal]}",
               cs._flash_inputs(torch, B, S, H, D, dtype, 41 + ci), causal,
               cs.timed_gate(dn), cs.k3_grads)
    B, S, H, D, causal = cs.FLASH_LONG
    inputs = cs._flash_inputs(torch, B, S, H, D, dtype, 47)
    yield (f"long-context {[B, S, H, D, causal]}", inputs, causal,
           cs.timed_gate(dn), cs.k3_grads)
    yield (f"long-context route {[B, S, H, D, causal]}", inputs, causal,
           cs.timed_gate(dn), cs.k3_route_grads)


def child(dtypes, sound_out, sound_in):
    """Every K3 case of this copy's kernel through both gates, one JSON
    line per (case, kernel); the sound run saves its outputs and their
    spread, a fault's run compares with them."""
    import torch

    import chip_smoke as cs

    # the plain version's products in full fp32, as in chip_smoke.py
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sound = torch.load(sound_in) if sound_in else None
    saved = {}
    for dn in dtypes:
        for name, (q, k, v, do), causal, gate, k3_grads in _cases(
                torch, cs, getattr(torch, dn)):
            want, got, _ = k3_grads(torch, q, k, v, do, causal)
            # each output's largest change over two more runs
            spreads = {kid: dict.fromkeys(grads, 0.0)
                       for kid, grads in got.items()}
            if sound is None:
                for _ in range(2):
                    again = k3_grads(torch, q, k, v, do, causal)[1]
                    for kid, grads in got.items():
                        for n, g in grads.items():
                            spreads[kid][n] = max(spreads[kid][n],
                                                  cs._err(again[kid][n], g))
            for kid, grads in got.items():
                finite = all(bool(torch.isfinite(g.float()).all())
                             for g in grads.values())
                rel = max(cs._rel_err(g, want[n]) for n, g in grads.items())
                shares = cs.k3_errors(gate, grads, want)
                row = {"dtype": dn, "case": name, "k3": kid,
                       "flash_gate_rel_err": rel,
                       "flash_gate": finite and rel <= cs.FLASH_TOL[gate],
                       "k3_limit_shares": shares,
                       "k3_gate": finite and cs.k3_passes(gate, grads,
                                                          want),
                       "gate": gate}
                key = f"{dn} {name} {kid}"
                if sound is None:
                    saved[key] = ({n: g.cpu() for n, g in grads.items()},
                                  spreads[kid])
                    row["spread"] = spreads[kid]
                    row["atol_needed"] = {}
                    for n, g in grads.items():
                        w = want[n].float()
                        err, mag = (g.float() - w).abs(), w.abs()
                        row["atol_needed"][n] = {
                            str(r): max(0.0, float((err - r * mag).max()))
                            for r in RTOLS[dn]}
                else:
                    ref, spread = sound[key]
                    moved = []
                    for n, g in grads.items():
                        g, r = g.cpu().float(), ref[n].float()
                        # K3a's dQ: a rounding its atomics' order flips
                        ulp = EPS[dn] * r.abs() if kid == "K3a" and n == "dQ" \
                            else 0.0
                        moved.append(not bool(((g - r).abs()
                                               <= 4 * spread[n] + ulp).all()))
                    row["changed"] = any(moved)
                print(json.dumps(row), flush=True)
    if sound_out:
        torch.save(saved, sound_out)


def main():
    import k1_fault_check

    k1_fault_check.drive(Path(__file__).resolve(), "flash_bwd.cu",
                         FAULTS, "k3_gate",
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
