"""Build the CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), under ``build/repro_torch_kernels/`` at the repository root.
The library's file name carries a hash of its source and flags, so an
edited source rebuilds and an unchanged one is reused.  A failed build
raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# C signatures of every entry point, by library
SIGNATURES: Dict[str, Dict[str, List]] = {
    "paged_attention": {
        "repro_paged_attention":
            [_I] + [_P] * 7 + [_I] * 8 + [_F, _P],
        "repro_paged_attention_quant":
            [_I] + [_P] * 9 + [_I] * 8 + [_F, _P],
        "repro_paged_split_tokens": [],
    },
    "flash_attention": {
        "repro_flash_fwd": [_I] + [_P] * 5 + [_I] * 7 + [_F, _I, _I, _P],
        "repro_flash_bwd": [_I] + [_P] * 10 + [_I] * 7 + [_F, _I, _I, _P],
        "repro_flash_bf16_smem": [_I, _I, _I],
        "repro_flash_bf16_dims": [_I, _I],
    },
    "xor_parity": {
        "repro_xor_reduce": [_P, _P, _I, _L, _I, _P],
    },
    "wkv6": {
        "repro_wkv6_fwd": [_I] + [_P] * 9 + [_I] * 4 + [_P],
        "repro_wkv6_bwd": [_I] + [_P] * 17 + [_I] * 4 + [_P],
        "repro_wkv6_blocks_per_sm": [_I],
    },
    "mamba2_ssd": {
        "repro_ssd_fwd": [_I] + [_P] * 9 + [_I] * 5 + [_P],
        "repro_ssd_bwd": [_I] + [_P] * 17 + [_I] * 6 + [_P],
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}
# compiler output (registers, shared memory, spills) of this process's builds
build_log: Dict[str, str] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or CUDA_HOME)")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    """Start building ``name`` unless its library is already there."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc()] + NVCC_FLAGS + ["-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    build_log[name] = log
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all() -> None:
    """Build every kernel library that is not built yet, one ``nvcc`` per
    source, all started together."""
    procs = {name: _start(name) for name in SIGNATURES}
    for name, proc in procs.items():
        _finish(name, proc)


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib
