"""Criteo-shaped recsys batches: multi-hot categorical ids + dense floats
(port of ``repro/data/recsys.py``).

Per-field ids are Zipf-distributed inside each field's row range (real CTR
id spaces are heavy-tailed: hot rows stress the embedding gather).
Stateless: batch = f(seed, step).  The reference draws with ``jax.random``
(threefry), which torch does not reproduce; here the uniforms come from
``numpy.random.default_rng((seed, step))``, as ``data/lm.py`` draws them,
so the stream differs from the reference's while :func:`_zipf_in_range`
maps the same uniforms to the same ids bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.index import _check_device
from repro_torch.data.lm import _pow_f32, _uniforms
from repro_torch.models.recsys import TableSpec


@dataclasses.dataclass(frozen=True)
class RecsysDataConfig:
    table: TableSpec = None  # type: ignore[assignment]
    batch: int = 65536
    nnz: int = 1
    n_dense: int = 0
    seed: int = 0
    zipf_a: float = 1.2


def _zipf_in_range(u: np.ndarray, n_rows: np.ndarray, a: float) -> np.ndarray:
    """Inverse-CDF Zipf ranks floor(u^(-1/(a-1))) of f32 uniforms ``u`` in
    [1e-6, 1), capped at ``n_rows - 1`` (broadcast against ``u``), int32.
    The reference casts the f32 floor to int32 first, which saturates at
    2**31 - 1 in JAX (u^-5 reaches 1e30) but wraps to -2**31 in numpy and
    torch; the cap is taken on the floor in f64 here, before the cast, which
    gives JAX's ids for every ``n_rows`` below 2**31.  The power is
    ``powf``'s wherever it can reach an id (below the largest ``n_rows``,
    past 2**24 for DLRM's first field)."""
    n_rows = np.asarray(n_rows, np.int64)
    p = _pow_f32(np.asarray(u, np.float32), -1.0 / (a - 1.0), below=max(2.0**24, n_rows.max()))
    return np.minimum(np.floor(p).astype(np.float64), n_rows - 1).astype(np.int32)


def batch_at(cfg: RecsysDataConfig, step: int, device="cuda") -> dict:
    """{'sparse': (B, F, nnz) int32 local ids, 'dense': (B, n_dense) f32
    (when ``n_dense``), 'label': (B,) f32 in {0, 1}} on ``device``.  The
    ids' uniforms are ``data/lm.py``'s stream for (seed, step); the labels
    (Bernoulli 0.25) and dense features (standard normal) draw from
    (seed, step, 1) and (seed, step, 2)."""
    dev = _check_device(device)
    shape = (cfg.batch, cfg.table.n_fields, cfg.nnz)
    rows = np.asarray(cfg.table.row_counts, np.int64)[None, :, None]
    sparse = _zipf_in_range(_uniforms(cfg.seed, step, shape), rows, cfg.zipf_a)
    label = np.random.default_rng((cfg.seed, step, 1)).random(cfg.batch) < 0.25
    out = {"sparse": torch.from_numpy(sparse).to(dev),
           "label": torch.from_numpy(label.astype(np.float32)).to(dev)}
    if cfg.n_dense:
        dense = np.random.default_rng((cfg.seed, step, 2)).standard_normal(
            (cfg.batch, cfg.n_dense), dtype=np.float32)
        out["dense"] = torch.from_numpy(dense).to(dev)
    return out
