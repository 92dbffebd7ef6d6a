"""Build and load the port's CUDA kernels.

Every ``paddle_tpu_torch/csrc/*.cu`` source is compiled by ``nvcc`` for
Hopper (``sm_90a``) into one shared library with a plain C interface,
``build/kernels/libpaddle_tpu_torch_kernels-<sha>.so`` at the root of the
checkout, named by the SHA-256 of the sources so an edit rebuilds. The
build runs at first use, never at import: the sources compile in
parallel (one ``nvcc -c`` per file, all started together) and link
once. The library is loaded with ``ctypes``; the wrappers pass every
pointer and the stream as ``c_void_p`` and every int as ``c_int``.

Only repository sources and the CUDA toolkit are used. A failed build
raises: there is no fallback to the plain versions for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional

__all__ = ["load_library", "build_dir", "sources", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parents[2]           # paddle_tpu_torch/
_CSRC = _PKG / "csrc"
_LIB_NAME = "paddle_tpu_torch_kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_VP, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                   ctypes.c_float)
# the flash kernels' tail: B, H, Sq, Sk, D; q and kv strides on (B, S,
# H); scale, causal, dtype, stream
_FLASH = [_I] * 5 + [_L] * 6 + [_F, _I, _I, _VP]
# C signature of every entry point (all return a cudaError_t as int)
_SIGNATURES = {
    "ptt_layer_norm_fwd": [_VP] * 6 + [_I, _I, _F, _I, _VP],
    # q, k/v pools, k/v scales (null at full precision), table, t, out;
    # the sizes; scale, q's type code, the pools' type code, stream
    "ptt_paged_attention_fwd": [_VP] * 8 + [_I] * 6 + [_F, _I, _I, _VP],
    # the same for bf16 or fp16 q: K4's tensor-core body
    "ptt_paged_decode_fwd": [_VP] * 8 + [_I] * 6 + [_F, _I, _I, _VP],
    # head dim, the pools' type code (bf16 or int8); out: clusters the
    # card holds at once and shared-memory bytes of the bf16 K4 body
    "ptt_paged_decode_occupancy": [_I, _I, _VP, _VP],
    "ptt_chunk_prefill_fwd": [_VP] * 8 + [_I] * 7 + [_F, _I, _I, _VP],
    # head dim, the pools' type code (bf16 or int8); out: CTAs per SM and
    # shared-memory bytes of the bf16 K5 body
    "ptt_chunk_prefill_occupancy": [_I, _I, _VP, _VP],
    "ptt_flash_fwd": [_VP] * 5 + _FLASH,
    # head dim; out: CTAs per SM and shared-memory bytes of the bf16 K1
    "ptt_flash_fwd_occupancy": [_I, _VP, _VP],
    "ptt_flash_bwd_fused": [_VP] * 9 + _FLASH,
    "ptt_flash_bwd_dkv": [_VP] * 8 + _FLASH,
    "ptt_flash_bwd_dq": [_VP] * 7 + _FLASH,
    # head dim, fused (1) or dK/dV only (0); out: CTAs per SM and
    # shared-memory bytes of the bf16 dK/dV body
    "ptt_flash_bwd_occupancy": [_I, _I, _VP, _VP],
    # head dim; out: the same for the bf16 dQ body
    "ptt_flash_bwd_dq_occupancy": [_I, _VP, _VP],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of this process's build


def build_dir() -> Path:
    """``build/kernels/`` at the root of the checkout (in .gitignore)."""
    return _PKG.parent / "build" / "kernels"


def sources() -> List[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(_CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
        "CUDA kernels of paddle_tpu_torch are compiled at first use and "
        "need the CUDA toolkit")


def _run_all(cmds: List[List[str]]):
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for c, p in zip(cmds, procs):
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"$ {' '.join(c)}\n{out}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def _build(target: Path):
    nvcc = _nvcc()
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources()]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                  for src, obj in zip(sources(), objs)])
        staged = Path(tmp) / target.name
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", *map(str, objs),
                   "-o", str(staged)]])
        # atomic publish: another process building at the same time
        # never loads a half-written library
        os.replace(staged, target)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        target = build_dir() / f"lib{_LIB_NAME}-{_digest()}.so"
        if not target.exists():
            t0 = time.perf_counter()
            _build(target)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(target))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(err: int, what: str):
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
