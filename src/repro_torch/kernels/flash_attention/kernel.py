"""Wrappers of the causal GQA flash-attention kernel (K9) and of its
backward: :func:`flash_attention` replaces ``repro/kernels/flash_attention/
kernel.py::flash_attention``, in ``csrc/flash_attention.cu``:
``flash_attention_bf16`` (bf16 products on tensor cores) and
``flash_attention_tf32`` (f32 as split TF32 on tensor cores, three tf32
products a product).  :func:`flash_attention_fwd` is the same kernel that
also writes each row's log-sum-exp, and :func:`flash_attention_bwd` the
gradient (``csrc/flash_attention_bwd.cu``, three or four CUDA kernels a call:
Delta, dK and dV, their sum over a split group (:func:`bwd_plan`), dQ; bf16
products on wgmma, f32 ones as split TF32 on mma.sync), which has no TPU
counterpart: the reference's kernel has no backward (its LM
differentiates einsum attention through XLA).

Routing follows the tensors' device: on the CPU the plain versions
(:mod:`.ref`) run; on one CUDA device the kernels launch on the current
stream, or the call raises.  Each wrapper's ``launches`` counts the calls
that launched on the card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import common
from repro_torch.kernels.flash_attention import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 96, 128)  # the kernel's instances
BWD_TILE = 64  # rows of the backward's tiles: keys a dK / dV block, query rows a dQ block


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return common.bind("flash_attention", flash_attention_launch=[i, i, p, p, p, p, i, i, i, i, p],
                       flash_attention_lse_launch=[i, i, p, p, p, p, p, i, i, i, i, p])


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return common.bind("flash_attention_bwd",
                       flash_attention_bwd_launch=[i, i, *[p] * 11, i, i, i, i, i, p])


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"want q (B, Hq, S, D), k and v (B, Hkv, S, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, d) or hkv == 0 or hq % hkv:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q {tuple(q.shape)} "
                         "(same B, S, D; Hq a multiple of Hkv)")


def _check_kernel_operands(*xs: torch.Tensor) -> None:
    """What the CUDA kernels take: all f32 or all bf16, D in HEAD_DIMS,
    contiguous."""
    q = xs[0]
    if q.dtype not in _DTYPES or any(x.dtype != q.dtype for x in xs):
        raise TypeError("q, k, v (and out, dout) must all be float32 or all bfloat16, got "
                        f"{[x.dtype for x in xs]}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} is not one of {HEAD_DIMS}")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError("q, k and v (and out, dout) must be contiguous")


def _aligned(*xs: torch.Tensor) -> tuple:
    """Each operand, copied where its data does not start on 16 bytes."""
    return tuple(x if x.data_ptr() % 16 == 0 else x.clone() for x in xs)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal GQA attention, forward only: q (B, Hq, S, D), k and v
    (B, Hkv, S, D), Hq a multiple of Hkv; query head h reads KV head
    h // (Hq // Hkv).  Returns (B, Hq, S, D) in q's dtype; statistics and
    products are f32 (bf16 operands multiply exactly; f32 ones as split
    TF32, to ~2^-22 of each product).  The kernel takes f32 or bf16 and D
    in :data:`HEAD_DIMS`, and copies 16-byte packs: an operand whose data
    does not start on 16 bytes is copied first.  On the CPU the plain
    version takes any D and dtype."""
    _check_shapes(q, k, v)
    # The plain version takes any head dim and dtype, as the reference does.
    if common.on_cpu(q, k, v):
        return ref.attention_ref(q, k, v)
    _check_kernel_operands(q, k, v)
    q, k, v = _aligned(q, k, v)
    b, hq, s, d = q.shape
    out = torch.empty_like(q)
    common.launch(_lib(), "flash_attention_launch", q.device, _DTYPES[q.dtype], d, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, k.shape[1], s)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0  # type: ignore[attr-defined]


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention` that also returns each row's log-sum-exp of
    its scaled, masked logits, ``lse`` (B, Hq, S) f32 in natural-log units:
    what :func:`flash_attention_bwd` recomputes the probabilities from.  One
    CUDA kernel a call on the card (``flash_attention_lse_launch``); on the
    CPU :func:`.ref.attention_fwd_ref`."""
    _check_shapes(q, k, v)
    if common.on_cpu(q, k, v):
        return ref.attention_fwd_ref(q, k, v)
    _check_kernel_operands(q, k, v)
    q, k, v = _aligned(q, k, v)
    b, hq, s, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    common.launch(_lib(), "flash_attention_lse_launch", q.device, _DTYPES[q.dtype], d,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, hq,
                  k.shape[1], s)
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0  # type: ignore[attr-defined]


def bwd_plan(b: int, hq: int, hkv: int, s: int, sms: int = 132) -> int:
    """The query heads each dK / dV block of the backward walks: the
    whole group of its KV head (one slice, no scratch), unless that walk,
    from key tile 0, would exceed half of what each of the card's block
    slots (two blocks an SM on ``sms`` SMs) does on average; then the most
    that stay under it, evened out over the slices of consecutive query
    heads (ceil(group / heads) of them, the last maybe shorter).  MHA: 1."""
    group = hq // hkv
    tiles = -(-s // BWD_TILE)
    fits = b * hq * (tiles + 1) // (4 * 2 * sms)  # heads a block may walk: half a slot's share
    slices = -(-group // max(1, min(group, fits)))
    return -(-group // slices)


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def bwd_scratch(q: torch.Tensor, k: torch.Tensor) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """(heads_per_block, stats, partial): the plan (:func:`bwd_plan`, both
    dtypes) and the f32 scratch of one backward launch: stats for (lse log2
    e, Delta) of every row, padded to whole tiles, and partial (2, B, Hkv,
    slices, S, D) of a split group's dK and dV (None without a split)."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    hpb = bwd_plan(b, hq, hkv, s, _sms(q.device))
    stats = torch.empty(b * hq * common.round_up(s, BWD_TILE) * 2, dtype=torch.float32,
                        device=q.device)
    slices = -(-(hq // hkv) // hpb)
    partial = (torch.empty((2, b, hkv, slices, s, d), dtype=torch.float32, device=q.device)
               if slices > 1 else None)
    return hpb, stats, partial


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of causal GQA attention ``out =
    flash_attention(q, k, v)`` given ``dout`` (q's shape) and the forward's
    ``out`` and ``lse`` (:func:`flash_attention_fwd`), each in its input's
    dtype, summed in f32 (dk and dv over the query heads of each KV head).
    On the card three CUDA kernels (Delta into an f32 scratch, dK and dV,
    dQ), and a fourth where :func:`bwd_plan` splits a group over blocks (the
    slices' dK and dV summed from an f32 scratch), with no atomics: the same
    inputs give the same bits.  bf16 multiplies on wgmma; f32 as split TF32
    (three tf32 products a product, each operand rounded to tf32 hi and lo
    parts) on mma.sync.  On the CPU :func:`.ref.attention_bwd_ref`."""
    _check_shapes(q, k, v)
    b, hq, s, d = q.shape
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != (b, hq, s):
        raise ValueError(f"want out and dout {tuple(q.shape)}, lse {(b, hq, s)}; got "
                         f"{tuple(out.shape)}, {tuple(dout.shape)}, {tuple(lse.shape)}")
    if lse.dtype != torch.float32:
        raise TypeError(f"lse must be float32, got {lse.dtype}")
    if common.on_cpu(q, k, v, out, lse, dout):
        return ref.attention_bwd_ref(q, k, v, out, lse, dout)
    _check_kernel_operands(q, k, v, out, dout)
    q, k, v, out, dout = _aligned(q, k, v, out, dout)
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    hpb, stats, partial = bwd_scratch(q, k)
    common.launch(_bwd_lib(), "flash_attention_bwd_launch", q.device, _DTYPES[q.dtype], d,
                  *(x.data_ptr() for x in (q, k, v, out, dout, lse, stats)),
                  None if partial is None else partial.data_ptr(),
                  *(x.data_ptr() for x in (dq, dk, dv)), b, hq, k.shape[1], s, hpb)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0  # type: ignore[attr-defined]
