#!/usr/bin/env python3
"""Planted faults in K1's bf16 kernel, held to chip_smoke.py's K1 gates.

Run from the root of a checkout on one Hopper card (``nvcc`` and
PyTorch built for CUDA): ``python3 k1_fault_check.py``. For the sound
kernel and then for each fault of ``FAULTS``, it copies
``paddle_tpu_torch/``, ``chip_smoke.py`` and itself into a fresh
temporary directory, plants the fault in the copy's
``csrc/flash_fwd.cu`` (the checkout is never edited), builds that
copy's kernels and runs every K1 case of ``chip_smoke.py`` (the cases of
``k1_case_inputs``, the timed shapes and the long-context shape) against
the plain version through two gates:

- the flash gate: O and lse each within ``FLASH_TOL`` relative to
  max(1, max |plain|), the limit every flash kernel is held to;
- K1's own gate, ``K1_TOL``: lse absolutely, O element by element.

It prints the card, one JSON line per (kernel, case) with both verdicts
and the errors they read (for the sound kernel also the atol that each
rtol of ``RTOLS`` would need), and one summary line per kernel. It exits
non-zero if the sound kernel fails a gate, or if a fault changes some
output and K1's gate catches it in no case. A fault whose outputs are
bitwise those of the sound kernel in every case (a race that did not
fire) is reported as such. ``k3_fault_check.py`` drives K3's faults
through the same copy-plant-run loop (:func:`drive`).
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

# name -> (source text in csrc/flash_fwd.cu, its faulty replacement)
FAULTS = {
    # a CTA of more than one key tile skips its last one
    "last key tile dropped": (
        "    const bool live = !a.causal || w0 + 15 >= k0;\n",
        "    const bool live = (!a.causal || w0 + 15 >= k0)"
        " && (more || j == 0);\n"),
    # only CTAs of 16 or more key tiles (rows past ~960) skip the last
    "last key tile of long rows dropped": (
        "    const bool live = !a.causal || w0 + 15 >= k0;\n",
        "    const bool live = (!a.causal || w0 + 15 >= k0)"
        " && (more || j < 15);\n"),
    # Q.K^T reads the ring stage that tile j + 1's copies are filling
    "K read from the other ring stage": (
        "    const bf16* kt = ks + (j & 1) * kTile * LDS;\n",
        "    const bf16* kt = ks + ((j + 1) & 1) * kTile * LDS;\n"),
    # the last tile's V copies may still be in flight during P.V
    "last V tile not waited for": (
        "      mma::cp_async_wait<0>();\n",
        "      mma::cp_async_wait<1>();\n"),
    # no barrier between a stage's last read and the copies refilling it
    "no barrier before a stage is refilled": (
        "    mma::cp_async_wait<1>();\n    __syncthreads();\n"
        "    if (more) {\n",
        "    mma::cp_async_wait<1>();\n    if (more) {\n"),
    # zero-filled keys past Sk get logit 0 instead of the mask
    "keys past Sk not masked": (
        "            if (col >= a.Sk || (a.causal && row < col))"
        " x = kMasked;\n",
        "            if (a.causal && row < col) x = kMasked;\n"),
}

# for the sound kernel: the atol each rtol would need on O
RTOLS = {"bfloat16": [0.0, 2.0 ** -8, 2.0 ** -7, 1e-2],
         "float32": [0.0, 1e-6, 1e-5]}


def _cases(torch, cs, dtype):
    for name, qkv, causal, _ in cs.k1_case_inputs(torch, dtype):
        yield name, qkv, causal
    for ci, (B, S, H, D, causal) in enumerate(cs.FLASH_CASES):
        yield (f"timed {[B, S, H, D, causal]}",
               cs._flash_inputs(torch, B, S, H, D, dtype, 41 + ci)[:3], causal)
    B, S, H, D, causal = cs.FLASH_LONG
    yield (f"long-context {[B, S, H, D, causal]}",
           cs._flash_inputs(torch, B, S, H, D, dtype, 47)[:3], causal)


def child(dtypes, sound_out, sound_in):
    """Every K1 case of this copy's kernel through both gates, one JSON
    line each; the sound run saves its outputs, a fault's run compares
    with them."""
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    # the plain version's products in full fp32, as in chip_smoke.py
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sound = torch.load(sound_in) if sound_in else None
    saved = {}
    for dn in dtypes:
        for name, qkv, causal in _cases(torch, cs, getattr(torch, dn)):
            scale = 1.0 / qkv[0].shape[-1] ** 0.5
            o, lse = fa.flash_fwd(*qkv, scale, causal)
            ro, rlse = fa.flash_fwd_ref(*qkv, scale, causal)
            finite = bool(torch.isfinite(o.float()).all()
                          and torch.isfinite(lse).all())
            rel = max(cs._rel_err(o, ro), cs._rel_err(lse, rlse))
            e_lse, share = cs.k1_errors(dn, o, ro, lse, rlse)
            row = {"dtype": dn, "case": name, "flash_gate_rel_err": rel,
                   "flash_gate": finite and rel <= cs.FLASH_TOL[dn],
                   "lse_err": e_lse, "o_max_abs_err": cs._err(o, ro),
                   "o_limit_share": share,
                   "k1_gate": finite and cs.k1_passes(dn, o, ro, lse, rlse)}
            key = f"{dn} {name}"
            if sound is None:
                saved[key] = (o.cpu(), lse.cpu())
                err, mag = (o.float() - ro.float()).abs(), ro.float().abs()
                row["atol_needed"] = {
                    str(r): max(0.0, float((err - r * mag).max()))
                    for r in RTOLS[dn]}
            else:
                so, slse = sound[key]
                row["changed"] = not (torch.equal(o.cpu(), so)
                                      and torch.equal(lse.cpu(), slse))
            print(json.dumps(row), flush=True)
    if sound_out:
        torch.save(saved, sound_out)


def copy_patched(root: Path, dst: Path, script: Path, source: str,
                 patches):
    """The port, ``chip_smoke.py``, this file and ``script`` into ``dst``,
    with each (text, replacement) of ``patches`` applied to the copy's
    ``csrc/<source>``; a text not in it exactly once stops the run."""
    shutil.copytree(root / "paddle_tpu_torch", dst / "paddle_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in {"chip_smoke.py", Path(__file__).name, script.name}:
        shutil.copy(root / name, dst / name)
    src = dst / "paddle_tpu_torch" / "csrc" / source
    text = src.read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise SystemExit(f"{script.name}: a patched text is not in "
                             f"{source} exactly once:\n{old}")
        text = text.replace(old, new)
    src.write_text(text)


def drive(script: Path, source: str, faults, gate: str,
          shared: str = "flash_gate", may_fault=(),
          fault_dtypes=("bfloat16",)):
    """For the sound kernel and then each of ``faults`` (name -> (text,
    replacement) in ``csrc/<source>``): a fresh copy, ``script --child``
    run in it (fp32 and bf16 for the sound kernel, ``fault_dtypes`` for a
    fault: bf16 unless the faults are in an fp32 body), its JSON rows
    echoed and summed up. Exits non-zero if the sound kernel
    fails the shared gate (the rows' ``shared`` verdict) or ``gate``, or
    if a fault changes an output and ``gate`` catches it in no case. A
    fault named in ``may_fault`` whose run fails (the kernel faulted on
    the card, say) is reported as caught by the run, not by a gate."""
    root = script.parent
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        sound = Path(tmp) / "sound.pt"
        for i, fault in enumerate([None, *faults]):
            dst = Path(tmp) / f"copy{i}"
            copy_patched(root, dst, script, source,
                         [] if fault is None else [faults[fault]])
            cmd = [sys.executable, str(dst / script.name), "--child"]
            cmd += (["--dtypes", "float32", "bfloat16", "--sound-out",
                     str(sound)] if fault is None
                    else ["--dtypes", *fault_dtypes, "--sound-in",
                          str(sound)])
            run = subprocess.run(cmd, cwd=dst, capture_output=True, text=True,
                                 timeout=900)
            label = fault or "sound"
            rows = [json.loads(line) for line in run.stdout.splitlines()
                    if line.startswith("{")]
            for row in rows:
                print(json.dumps({"kernel": label, **row}), flush=True)
            if run.returncode != 0:
                print(run.stderr[-4000:], file=sys.stderr, flush=True)
                if fault in may_fault:
                    print("summary " + json.dumps(
                        {"kernel": label, "cases": len(rows),
                         "run_failed": run.returncode}), flush=True)
                    continue
                bad.append(f"{label}: the run failed (rc {run.returncode})")
                continue
            summary = {
                "kernel": label, "cases": len(rows),
                "changed": sum(r.get("changed", False) for r in rows),
                f"{shared}_failed": sum(not r[shared] for r in rows),
                f"{gate}_failed": sum(not r[gate] for r in rows)}
            print("summary " + json.dumps(summary), flush=True)
            if fault is None and (summary[f"{shared}_failed"]
                                  or summary[f"{gate}_failed"]):
                bad.append("the sound kernel fails a gate")
            if fault is not None and summary["changed"] \
                    and not summary[f"{gate}_failed"]:
                bad.append(f"{fault}: outputs changed, {gate} passed")
    if bad:
        print(f"{script.name}: FAIL: " + "; ".join(bad), file=sys.stderr)
        sys.exit(1)
    print(f"{script.name}: ok", flush=True)


def main():
    drive(Path(__file__).resolve(), "flash_fwd.cu", FAULTS, "k1_gate")


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
