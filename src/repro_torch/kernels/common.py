"""Shared kernel utilities: tiling helpers and the CUDA build.

Each kernel source under ``kernels/<name>/csrc/`` has a plain C interface and
is compiled by ``nvcc`` for ``sm_90a`` into a shared library on first use,
then bound with ``ctypes``.  Libraries go to ``<repo>/build/kernels/`` (listed
in ``.gitignore``), named by a hash of the source and flags, so an edited
source is rebuilt and an unchanged one is reused within a checkout.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

# Sentinel id of empty running top-k slots (reported as -1).
BIG_ID = 2**30

_KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS_DIR.parents[2] / "build" / "kernels"

SOURCES: Dict[str, Path] = {
    "fused_topk": _KERNELS_DIR / "fused_topk" / "csrc" / "fused_topk.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def next_pow2(x: int) -> int:
    """Smallest power of two >= x."""
    return 1 << max(0, (x - 1).bit_length())


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return path


def library_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named kernel sources (default: all) that are not built
    yet, one ``nvcc`` per source, all started together.  Returns each
    compiled source's compiler output (``-Xptxas -v``: registers, shared
    memory, spills); raises with that output if a compile fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        jobs[name] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {}
    for name, (out, tmp, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
        logs[name] = log
    return logs


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
