"""Wrapper of the causal GQA flash-attention kernel (K9):
:func:`flash_attention` replaces ``repro/kernels/flash_attention/kernel.py::
flash_attention``, in ``csrc/flash_attention.cu``: ``flash_attention_bf16``
(bf16 products on tensor cores) and ``flash_attention_tf32`` (f32 as split
TF32 on tensor cores, three tf32 products a product).

Routing follows the tensors' device: on the CPU the plain version
(:mod:`.ref`) runs; on one CUDA device the kernel launches on the current
stream, or the call raises.  ``flash_attention.launches`` counts the calls
that launched on the card (one CUDA kernel each).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import common
from repro_torch.kernels.flash_attention import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 96, 128)  # the kernel's instances


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return common.bind("flash_attention", flash_attention_launch=[i, i, p, p, p, p, i, i, i, i, p])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal GQA attention, forward only: q (B, Hq, S, D), k and v
    (B, Hkv, S, D), Hq a multiple of Hkv; query head h reads KV head
    h // (Hq // Hkv).  Returns (B, Hq, S, D) in q's dtype; statistics and
    products are f32 (bf16 operands multiply exactly; f32 ones as split
    TF32, to ~2^-22 of each product).  The kernel takes f32 or bf16 and D
    in :data:`HEAD_DIMS`, and copies 16-byte packs: an operand whose data
    does not start on 16 bytes is copied first.  On the CPU the plain
    version takes any D and dtype."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"want q (B, Hq, S, D), k and v (B, Hkv, S, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, d) or hkv == 0 or hq % hkv:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q {tuple(q.shape)} "
                         "(same B, S, D; Hq a multiple of Hkv)")
    # The plain version takes any head dim and dtype, as the reference does.
    if common.on_cpu(q, k, v):
        return ref.attention_ref(q, k, v)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or all bfloat16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (q, k, v))
    out = torch.empty_like(q)
    common.launch(_lib(), "flash_attention_launch", q.device, _DTYPES[q.dtype], d, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv, s)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0  # type: ignore[attr-defined]
