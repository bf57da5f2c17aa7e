"""Shared kernel utilities: tiling helpers, the canonical int4 dequant, the
device routing and f32 product of the wrappers and plain versions, and the
CUDA build.

Each kernel source under ``kernels/<name>/csrc/`` has a plain C interface and
is compiled by ``nvcc`` for ``sm_90a`` into a shared library on first use,
then bound with ``ctypes`` (:func:`bind`) and launched through
:func:`launch`.  Headers shared by several sources live in
``kernels/csrc/`` (on the include path of every build).  Libraries go to
``<repo>/build/kernels/`` (listed in ``.gitignore``), named by a hash of every
file in the source's ``csrc/`` directory and in ``kernels/csrc/`` (headers
included) and the flags, so an edited source or header is rebuilt and an
unchanged one is reused within a checkout.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import torch

# Sentinel id of empty running top-k slots (reported as -1).
BIG_ID = 2**30

_KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS_DIR.parents[2] / "build" / "kernels"

SHARED_CSRC = _KERNELS_DIR / "csrc"

SOURCES: Dict[str, Path] = {
    "fused_topk": _KERNELS_DIR / "fused_topk" / "csrc" / "fused_topk.cu",
    "fused_topk_quantized": _KERNELS_DIR / "fused_topk" / "csrc" / "fused_topk_quantized.cu",
    "fakewords_score": _KERNELS_DIR / "fakewords_score" / "csrc" / "fakewords_score.cu",
    "cosine_score": _KERNELS_DIR / "cosine_score" / "csrc" / "cosine_score.cu",
    "lsh_match": _KERNELS_DIR / "lsh_match" / "csrc" / "lsh_match.cu",
    "flash_attention": _KERNELS_DIR / "flash_attention" / "csrc" / "flash_attention.cu",
    "flash_attention_bwd": _KERNELS_DIR / "flash_attention" / "csrc" / "flash_attention_bwd.cu",
}

# Packed int4 padding byte: nibble 8 in both halves, which dequantizes to 0.
INT4_PAD_BYTE = 0x88

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def next_pow2(x: int) -> int:
    """Smallest power of two >= x."""
    return 1 << max(0, (x - 1).bit_length())


# --------------------------------------------------------------------------
# Canonical int4 nibble unpack / grouped-scale dequantization (port of
# ``repro/kernels/common.py``).  The build-time quantizer, the plain scoring
# versions and the blockmax bounds all run this one sequence, so their
# dequantized operands are equal bit for bit; the CUDA kernels repeat it per
# element.
# --------------------------------------------------------------------------


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 nibble pairs (..., C) -> interleaved nibble columns (..., 2C)
    uint8: the low nibble is the even column, the high nibble the odd one.
    The shift stays on uint8, where it is logical (on int8 it would
    sign-fill the high nibble)."""
    if packed.dtype != torch.uint8:
        raise TypeError(f"packed int4 data must be uint8, got {packed.dtype}")
    lo = packed & 0xF
    hi = packed >> 4
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], 2 * packed.shape[-1])


def expand_group_scale(scale: torch.Tensor, group: int) -> torch.Tensor:
    """(..., G) per-group scales -> (..., G * group) per-column."""
    return scale.repeat_interleave(group, dim=-1)


def dequant_int4(packed: torch.Tensor, scale: torch.Tensor, group: int, dtype: Any) -> torch.Tensor:
    """THE canonical int4 dequant order: f32 (nibble - 8) * group_scale, then
    ONE cast to ``dtype``.  (..., C) packed + (..., 2C/group) scales ->
    (..., 2C) values."""
    nib = unpack_int4(packed).to(torch.float32) - 8.0
    return (nib * expand_group_scale(scale, group)).to(dtype)


def on_cpu(*tensors: Optional[torch.Tensor]) -> bool:
    """Where a wrapper runs: True when every operand lies on the CPU (the
    plain version), False when all lie on one CUDA device (the kernel).
    Raises for anything else.  ``None`` operands are ignored."""
    devices = {x.device for x in tensors if x is not None}
    if devices == {torch.device("cpu")}:
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"operands must all lie on the CPU or on one CUDA device, got {devices}")
    return False


def row_alignment(x: torch.Tensor) -> int:
    """The byte alignment (16, 8, 4, or 1) every row of the contiguous 2-D
    ``x`` starts at.  Only K4's f32-query loader and K5 take 4-byte rows;
    every other kernel treats 4 as 1."""
    row = x.shape[1] * x.element_size()
    for a in (16, 8, 4):
        if x.data_ptr() % a == 0 and row % a == 0:
            return a
    return 1


def f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (batched or not) with both operands widened to f32, in full
    f32: on the card TF32 is switched off for this product only (the
    caller's setting is restored)."""
    a, b = a.float(), b.float()
    if not (a.is_cuda and torch.backends.cuda.matmul.allow_tf32):
        return a @ b
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = True


def stable_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top ``k`` of each row of ``scores`` with ``lax.top_k``'s order:
    descending, ties to the lowest index (``torch.topk`` promises no tie
    order).  Returns (values, int32 indices)."""
    s, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k].to(torch.int32)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return path


def library_path(name: str) -> Path:
    """The built library of source ``name``, keyed by a hash of the flags
    and of every file in the source's ``csrc/`` directory and in the shared
    ``kernels/csrc/`` (a header the source includes counts as much as the
    source)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for d in (SOURCES[name].parent, SHARED_CSRC):
        for f in sorted(p for p in d.rglob("*") if p.is_file()):
            h.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


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
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(SHARED_CSRC), "-o", str(tmp), str(SOURCES[name])]
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
    """The kernel's shared library, built on first use.  Every source
    exports ``<name>_error_string`` (the text of a cudaError code), bound
    here as the library's ``error_string``."""
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    lib.error_string = getattr(lib, f"{name}_error_string")
    lib.error_string.argtypes, lib.error_string.restype = [ctypes.c_int], ctypes.c_char_p
    return lib


def bind(name: str, **entries: Sequence[Any]) -> ctypes.CDLL:
    """Library ``name`` (:func:`load_library`) with each C entry named in
    ``entries`` given its argument types and an int result (a cudaError
    code for a launch entry, 0 or 1 for a plan)."""
    lib = load_library(name)
    for entry, argtypes in entries.items():
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    return lib


def launch(lib: ctypes.CDLL, entry: str, device: torch.device, *args: Any) -> None:
    """Call the launch entry ``entry`` of ``lib`` (bound by :func:`bind`)
    with ``args`` and ``device``'s current stream, on that device.  Raises
    RuntimeError if it returns a cudaError."""
    with torch.cuda.device(device):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: cudaError {err} ({lib.error_string(err).decode()})")
