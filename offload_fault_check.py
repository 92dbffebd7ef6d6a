#!/usr/bin/env python3
"""Planted faults in ZeRO offload's synchronisation, held to chip_smoke.py's
phase 6e gate.

Run from the root of a checkout on one Hopper card (``nvcc`` and
PyTorch built for CUDA): ``python3 offload_fault_check.py``. For the
sound trainer and then for each fault of ``FAULTS``, it copies
``paddle_tpu_torch/``, ``chip_smoke.py`` and itself into a fresh
temporary directory, plants the fault in the copy's
``paddle_tpu_torch/distributed/trainer.py`` (the checkout is never
edited), and runs phase 6e there (``chip_smoke.offload_phase``: 12
steps of an offloaded ``gpt2_small`` trainer in lockstep with 12 of one
without, both fed the same gradients, held bitwise: losses, parameters,
every slot, the checkpoint).

It prints the card, one JSON line per run (the fault, whether 6e
failed, and the first failure's text) and exits non-zero if the sound
trainer fails 6e, or if a fault that ``ESCAPES`` does not name passes
it. A fault in ``ESCAPES`` passes on an H100 because of timing alone
(the race it opens never lines up), which no output gate can see; its
reason is stated beside it.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

TARGET = "paddle_tpu_torch/distributed/trainer.py"

# name -> (source text in TARGET, its faulty replacement)
FAULTS = {
    # the copy-out's device buffers go back to the allocator with no
    # record of the side stream still reading them: the next forward may
    # overwrite a slot before its copy lands on the host
    "copy-out buffers not kept for the side stream": (
        "                dev.record_stream(side)\n", ""),
    # the side stream starts the copy-out without waiting for the update
    # queued on the compute stream: the host may get a slot before it
    "copy-out not waiting for the update": (
        "        side.wait_stream(torch.cuda.current_stream(self.device))\n",
        ""),
    # the next copy-in does not wait for the last copy-out on the device
    "copy-in not waiting for the copy-out": (
        "            torch.cuda.current_stream(self.device).wait_event(\n"
        "                self._out_done)\n",
        "            pass\n"),
}
# faults that pass 6e on timing alone, with the reason
ESCAPES = {
    "copy-in not waiting for the copy-out":
        "the copy-out (~20 ms) lands early in the next step's forward, "
        "~150 ms before that step's copy-in reads the host buffers",
}


def child():
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_phase(torch)
    cs.build_phase()
    cs.offload_phase(torch, card, {"tokens_per_s": 0.0, "step_p50_ms": 0.0,
                                   "peak_gib": 0.0})


def _copy(root: Path, dst: Path, script: Path, fault):
    shutil.copytree(root / "paddle_tpu_torch", dst / "paddle_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("chip_smoke.py", script.name):
        shutil.copy2(root / name, dst / name)
    if fault is not None:
        text, new = fault
        path = dst / TARGET
        src = path.read_text()
        if src.count(text) != 1:
            raise SystemExit(f"fault text not found once in {TARGET}: "
                             f"{text!r}")
        path.write_text(src.replace(text, new))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--child", action="store_true")
    ap.add_argument("faults", nargs="*", help="names of FAULTS (default: "
                    "all)")
    args = ap.parse_args()
    if args.child:
        child()
        return
    script = Path(__file__).resolve()
    root = script.parent
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    names = args.faults or list(FAULTS)
    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, name in enumerate([None, *names]):
            dst = Path(tmp) / f"copy{i}"
            _copy(root, dst, script, None if name is None else FAULTS[name])
            run = subprocess.run([sys.executable, script.name, "--child"],
                                 cwd=dst, capture_output=True, text=True,
                                 timeout=900)
            lines = (run.stdout + run.stderr).splitlines()
            failure = next((ln for ln in lines if "FAIL" in ln
                            or "Error" in ln), None)
            row = {"fault": name or "sound", "caught": run.returncode != 0,
                   "rc": run.returncode, "failure": failure}
            print(json.dumps(row), flush=True)
            if name is None and run.returncode != 0:
                print(run.stderr[-4000:], file=sys.stderr, flush=True)
                bad.append("the sound trainer fails 6e")
            if name is not None and run.returncode == 0 \
                    and name not in ESCAPES:
                bad.append(f"{name}: passed 6e")
    if bad:
        raise SystemExit("; ".join(bad))


if __name__ == "__main__":
    main()
