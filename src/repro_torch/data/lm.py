"""Stateless LM token pipeline: batch = f(seed, step) (port of
``repro/data/lm.py``).

Synthetic token streams with a Zipfian unigram distribution.  Deterministic
per (seed, step, shard), so restarts and re-sharding reproduce the same
global batch.  The reference draws its uniforms with ``jax.random``
(threefry), which torch does not reproduce; here they come from
``numpy.random.default_rng((seed, step))``, so the token streams differ
from the reference's while :func:`_zipf_tokens` maps the same uniforms to
the same tokens bit for bit.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LmDataConfig:
    vocab: int = 32064
    seq_len: int = 4096
    global_batch: int = 256
    seed: int = 0
    zipf_a: float = 1.1


@functools.lru_cache(maxsize=None)
def _powf():
    """The C library's single-precision ``powf``, which the reference's
    f32 power lowers to on the CPU."""
    fn = ctypes.CDLL(ctypes.util.find_library("m")).powf
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float, ctypes.c_float]
    return fn


def _pow_f32(u: np.ndarray, e: float, below: float = 2.0**24) -> np.ndarray:
    """``powf(u, e)`` elementwise where its floor can matter: the power is
    taken in f64, and where it lies within a few f32 steps of an integer
    below ``below`` (where ``powf``'s last bit can move the floor; from
    2**24 up every f32 is an integer, and ``powf``'s rounding moves the
    value itself) the value is ``powf``'s own."""
    t = np.power(u.astype(np.float64), float(np.float32(e)))
    with np.errstate(over="ignore"):  # past the f32 range: inf, as powf gives
        out = t.astype(np.float32)
    near = (t < below) & (np.abs(t - np.round(t)) <= 4 * np.spacing(out))
    pf = _powf()
    out[near] = [pf(float(x), float(e)) for x in u[near]]
    return out


def _zipf_tokens(u: np.ndarray, vocab: int, a: float) -> np.ndarray:
    """Inverse-CDF Zipf sampling of f32 uniforms ``u`` in [1e-6, 1): rank
    floor(u^(-1/(a-1))) clipped to [0, vocab - 1], int32 (the reference's
    f32 arithmetic, its saturating cast of ranks past int32 included)."""
    if vocab > 2**24:
        raise ValueError(f"vocab {vocab} past 2**24: f32 ranks are not exact there")
    x = _pow_f32(np.asarray(u, np.float32), -1.0 / (a - 1.0))
    return np.minimum(np.floor(x), vocab - 1).astype(np.int32)


def _uniforms(seed: int, step: int, shape) -> np.ndarray:
    """f32 uniforms in [1e-6, 1), as ``jax.random.uniform(minval=1e-6)``
    scales its [0, 1) draws."""
    r = np.random.default_rng((seed, step)).random(shape, dtype=np.float32)
    lo = np.float32(1e-6)
    return np.maximum(lo, lo + (np.float32(1.0) - lo) * r)


def batch_at(cfg: LmDataConfig, step: int) -> dict:
    """Global batch for ``step``: {'tokens': (B, S), 'labels': (B, S)} int32
    CPU tensors; labels are the next-token shifted tokens."""
    u = _uniforms(cfg.seed, step, (cfg.global_batch, cfg.seq_len + 1))
    toks = torch.from_numpy(_zipf_tokens(u, cfg.vocab, cfg.zipf_a))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def host_shard_at(cfg: LmDataConfig, step: int, shard: int, n_shards: int) -> dict:
    """This host's rows of the global batch (each host materializes only
    its rows; they agree across hosts because the draw depends only on
    (seed, step))."""
    if cfg.global_batch % n_shards:
        raise ValueError(f"global_batch {cfg.global_batch} is not a multiple of {n_shards}")
    per = cfg.global_batch // n_shards
    return {k: v[shard * per:(shard + 1) * per] for k, v in batch_at(cfg, step).items()}
