#!/usr/bin/env python3
"""Planted faults in K1 and K3a, held to chip_smoke.py's phase 8d gate.

Run from the root of a checkout on one Hopper card (``nvcc`` and
PyTorch built for CUDA): ``python3 fused_fault_check.py``. For the sound
kernels and then for each fault of ``faults()`` (taken by name from
``k1_fault_check.FAULTS`` and ``k3_fault_check.FAULTS``), it copies
``paddle_tpu_torch/``, ``chip_smoke.py``, ``k1_fault_check.py`` and
itself into a fresh temporary directory, plants the fault in the copy's
``csrc/flash_fwd.cu`` or ``csrc/flash_bwd.cu`` (the checkout is never
edited), and runs ``chip_smoke.fused_readings`` there: the 12-layer
fused encoder stack at 32 x 512 under bf16 AMP on the flash route and
on the plain route, each held to the same stack in fp32. It prints the
card, one JSON line per kernel with the readings and what
``chip_smoke.fused_failures`` finds wrong, and exits non-zero if the
sound kernels fail the gate or a fault passes it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

# name -> (source in csrc/, the fault's name in that kernel's checker)
PLANTED = {
    "K1: last key tile dropped": ("flash_fwd.cu", "k1_fault_check",
                                  "last key tile dropped"),
    "K3a: last query tile of the sweep dropped": (
        "flash_bwd.cu", "k3_fault_check",
        "last query tile of the sweep dropped"),
    "K3a: one warp's dQ atomics skipped": (
        "flash_bwd.cu", "k3_fault_check", "one warp's dQ atomics skipped"),
}


def faults():
    """name -> (source, text, replacement) of every planted fault."""
    import importlib

    out = {}
    for name, (source, module, fault) in PLANTED.items():
        out[name] = (source, *importlib.import_module(module).FAULTS[fault])
    return out


def child():
    """The readings of this copy's kernels and the gate's verdict, as one
    JSON line."""
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = cs.fused_readings(torch)
    r["failures"] = cs.fused_failures(r)
    print(json.dumps(r), flush=True)


def main():
    import k1_fault_check

    script = Path(__file__).resolve()
    root = script.parent
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    planted = faults()
    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, name in enumerate([None, *planted]):
            dst = Path(tmp) / f"copy{i}"
            source, patches = "flash_fwd.cu", []
            if name is not None:
                source, text, faulty = planted[name]
                patches = [(text, faulty)]
            k1_fault_check.copy_patched(root, dst, script, source, patches)
            run = subprocess.run([sys.executable, str(dst / script.name),
                                  "--child"], cwd=dst, capture_output=True,
                                 text=True, timeout=900)
            label = name or "sound"
            rows = [json.loads(line) for line in run.stdout.splitlines()
                    if line.startswith("{")]
            if run.returncode != 0 or len(rows) != 1:
                print(run.stderr[-4000:], file=sys.stderr, flush=True)
                bad.append(f"{label}: the run failed (rc {run.returncode})")
                continue
            row = rows[0]
            print(json.dumps({"kernel": label, **row}), flush=True)
            if name is None and row["failures"]:
                bad.append("the sound kernels fail the gate")
            if name is not None and not row["failures"]:
                bad.append(f"{name}: passed the gate")
    if bad:
        print(f"{script.name}: FAIL: " + "; ".join(bad), file=sys.stderr)
        sys.exit(1)
    print(f"{script.name}: ok", flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--child", action="store_true")
    if ap.parse_args().child:
        child()
    else:
        main()
