#!/usr/bin/env python3
"""Design variants of K2's LayerNorm kernel, timed side by side on one card.

Run from the root of a checkout on one Hopper card (``nvcc`` and
PyTorch built for CUDA): ``python3 k2_variants.py [--parent DIR]
[NAME ...]`` (the named variants of ``VARIANTS``, by default all). Each
variant is a set of text patches on ``csrc/layer_norm.cu``: the kernel
as built (one warp a row, 4 warps a CTA, a grid of the CTAs the card
holds, w and b in registers), and the choices its design rejected: 8
warps a CTA; w and b read again for every row; a grid of one row a warp
(no striding). With ``--parent DIR``, a checkout of an earlier commit
(``git archive <commit> | tar -x -C DIR``), that commit's
``csrc/layer_norm.cu`` is one more variant, "parent". For each one it
copies the port into a fresh temporary directory and patches the copy
(``k1_fault_check.copy_patched``; the checkout is never edited), builds
every copy at once, then prints per variant

- ``nvcc -Xptxas -v``'s registers and spills of each warp-kernel
  instantiation that the timed shapes run (``ln_warp_kernel<T, VPL>``);
- one JSON line per timed K2 shape of ``chip_smoke.py`` (``K2_TIMED``,
  fp32 and bf16): the device time (``chip_smoke.Timer``: median of
  single launches, cold L2) and, over every K2 case, the largest share
  of ``K2_TOL`` (reported, not enforced: an earlier kernel may centre
  its rows on a mean rounded once more, which K2_TOL's large-mean case
  does not pass).

The variants run one after another in one process each, so their times
compare within the call. It exits non-zero if a variant's build or run
fails. :func:`run` is the loop, which ``k45_f32_variants.py`` shares.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _csrc(name):
    return (ROOT / "paddle_tpu_torch" / "csrc" / name).read_text()


def _warp_launch():
    """launch_warp's grid expression as built (read from the checkout)."""
    src = _csrc("layer_norm.cu")
    return src[src.index("  const int grid = static_cast<int>("):
               src.index("  kern<<<grid, kThreads, 0, stream>>>")]


# name -> [(source text in csrc/layer_norm.cu, or a callable giving it,
# replacement), ...]
VARIANTS = {
    "as built": [],
    "8 warps a CTA": [("constexpr int kWarps = 4;", "constexpr int kWarps = 8;")],
    # w and b read (from L1/L2) for every row, not held in registers
    "w and b read for every row": [
        ("          P::load(wv[v], a);\n",
         "          P::load(reinterpret_cast<const uint4*>(w)[lane + 32 * v],"
         " a);\n"),
        ("          P::load(bv[v], a);\n",
         "          P::load(reinterpret_cast<const uint4*>(b)[lane + 32 * v],"
         " a);\n")],
    # every warp takes one row: ceil(R / kWarps) CTAs, whatever the card
    # holds
    "one row a warp": [(
        _warp_launch,
        "  (void)full;\n"
        "  const int grid = (R + kWarps - 1) / kWarps;\n")],
}


def parent_files(parent, names):
    """Patches that replace each ``csrc/<name>`` of ``names`` by the
    parent checkout's."""
    return [(f"csrc/{n}", (lambda n=n: _csrc(n)),
             (lambda n=n: (Path(parent) / "paddle_tpu_torch" / "csrc" / n)
              .read_text())) for n in names]


_KERNEL = re.compile(r"ln_warp_kernelI(f|13__nv_bfloat16)Li(\d+)E")


def child(build_only: bool):
    """Build this copy's kernels; unless ``build_only``, time every timed
    K2 shape, one JSON line each."""
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import layer_norm as k2

    _build.load_library()
    if build_only:
        return
    timer = cs.Timer(torch)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        worst = 0.0
        for case in cs.k2_case_inputs(torch, dtype):
            share = cs.k2_errors(dn, case, *cs.k2_run(torch, case))[2]
            worst = max(worst, share) if share == share else float("nan")
            if not case["timed"]:
                continue
            x, (w, b) = case["x"], case["wb"]
            ms = timer(lambda: k2.layer_norm_fwd(x, w, b, 1e-5))
            print(json.dumps({"dtype": dn, "case": case["shape"],
                              "kernel_ms": ms}), flush=True)
        print(json.dumps({"dtype": dn, "k2_limit_share": worst}), flush=True)


def _text(t):
    return t() if callable(t) else t


def _ptxas(nvcc, flags, src: Path, obj: Path):
    return subprocess.Popen([nvcc, *flags, "-Xptxas", "-v", "-c", str(src),
                             "-o", str(obj)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def run(script: Path, source: str, variants, names, kernel: re.Pattern,
        label, ptxas_source=None):
    """Every variant of ``variants`` named in ``names`` (all if empty): a
    patched copy each (patches: (text, replacement) on ``csrc/<source>``,
    or (file under paddle_tpu_torch/, text, replacement); either text may
    be a callable giving it), all built at once, then
    ``script --child`` in each, one after another; the registers of each
    instantiation whose mangled name ``kernel`` matches in
    ``csrc/<ptxas_source>`` (default ``source``; ``label`` names it from
    the match) and the child's JSON lines, per variant."""
    import k1_fault_check
    from paddle_tpu_torch.ops.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    unknown = set(names) - set(variants)
    if unknown:
        raise SystemExit(f"{script.name}: no variant {sorted(unknown)}")
    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {}
        for i, (name, patches) in enumerate(variants.items()):
            if names and name not in names:
                continue
            dirs[name] = Path(tmp) / f"v{i}"
            k1_fault_check.copy_patched(
                ROOT, dirs[name], script, source,
                [(_text(old), _text(new))
                 for old, new in (p for p in patches if len(p) == 2)])
            for rel, old, new in (p for p in patches if len(p) == 3):
                f = dirs[name] / "paddle_tpu_torch" / rel
                text = f.read_text()
                old, new = _text(old), _text(new)
                if text.count(old) != 1:
                    raise SystemExit(f"{script.name}: a patched text is not "
                                     f"in {rel} exactly once:\n{old}")
                f.write_text(text.replace(old, new))
        procs = {n: (_ptxas(_build._nvcc(), _build.NVCC_FLAGS,
                            d / "paddle_tpu_torch" / "csrc"
                            / (ptxas_source or source),
                            d / "variant.o"),
                     subprocess.Popen([sys.executable, script.name, "--child",
                                       "--build-only"], cwd=d))
                 for n, d in dirs.items()}
        regs = {}
        for n, (px, build) in procs.items():
            out = px.communicate()[0]
            if px.returncode != 0 or build.wait() != 0:
                bad.append(f"{n}: the build failed")
                print(out[-3000:], file=sys.stderr, flush=True)
                continue
            what, regs[n] = None, []
            for line in out.splitlines():
                if "Compiling entry function" in line:
                    m = kernel.search(line)
                    what = m and label(m)
                elif what and "spill stores" in line:
                    regs[n].append([what, line.strip()])
                elif what and "Used" in line:
                    regs[n][-1].append(line.split("Used", 1)[1].split(",")[0]
                                       .strip())
                    what = None
        for n, d in dirs.items():
            if n not in regs:
                continue
            print(f"== {n}", flush=True)
            for what, spill, used in regs[n]:
                print(f"  ptxas {what}: {used}, {spill}", flush=True)
            proc = subprocess.run([sys.executable, script.name, "--child"],
                                  cwd=d, capture_output=True, text=True,
                                  timeout=900)
            for line in proc.stdout.splitlines():
                if line.startswith("{"):
                    print("  " + json.dumps({"variant": n,
                                             **json.loads(line)}), flush=True)
            if proc.returncode != 0:
                print(proc.stderr[-3000:], file=sys.stderr, flush=True)
                bad.append(f"{n}: the run failed (rc {proc.returncode})")
    if bad:
        print(f"{script.name}: FAIL: " + "; ".join(bad), file=sys.stderr)
        sys.exit(1)
    print(f"{script.name}: ok", flush=True)


def _label(m):
    return f"{'fp32' if m.group(1) == 'f' else 'bf16'}, VPL {m.group(2)}"


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", help="variants to run (default all)")
    ap.add_argument("--parent", help="an earlier commit's checkout, whose "
                    "kernel is timed as the variant 'parent'")
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--build-only", action="store_true")
    args = ap.parse_args()
    if args.child:
        child(args.build_only)
    else:
        if args.parent:
            VARIANTS["parent"] = parent_files(args.parent, ["layer_norm.cu"])
        run(Path(__file__).resolve(), "layer_norm.cu", VARIANTS, args.names,
            _KERNEL, _label)
