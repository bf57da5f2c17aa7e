"""Synthetic embedding corpora with word2vec-like spectral statistics.

A copy of ``repro/data/embeddings.py``: the same numpy draws, so the same
seed gives the same arrays in both packages.  The paper's corpora (word2vec
GoogleNews, GloVe Twitter, both 300-d) are synthesized with matched
statistics: a power-law singular-value spectrum, a common mean component
(what PPA removes) and heavy-tailed per-vector norms.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CorpusConfig:
    name: str = "word2vec-like"
    n_vectors: int = 100_000
    dim: int = 300
    alpha: float = 1.0         # spectrum decay
    mean_strength: float = 0.6  # common-component magnitude (PPA target)
    seed: int = 0


def make_corpus(cfg: CorpusConfig) -> np.ndarray:
    """(N, dim) float32 with the statistics above.  The first draw is float64
    normals (8 bytes per entry on the host) cast down, as in the reference."""
    rng = np.random.default_rng(cfg.seed)
    z = rng.standard_normal((cfg.n_vectors, cfg.dim)).astype(np.float32)
    s = (np.arange(1, cfg.dim + 1, dtype=np.float32)) ** (-cfg.alpha)
    s = s / np.sqrt(np.mean(s**2))
    q, _ = np.linalg.qr(rng.standard_normal((cfg.dim, cfg.dim)).astype(np.float32))
    x = (z * s[None, :]) @ q
    mu = rng.standard_normal(cfg.dim).astype(np.float32)
    mu = mu / np.linalg.norm(mu) * cfg.mean_strength
    x = x + mu[None, :]
    scale = rng.pareto(3.0, cfg.n_vectors).astype(np.float32) + 1.0
    x = x * scale[:, None]
    return x


def make_queries(
    corpus: np.ndarray, n_queries: int, seed: int = 1, jitter: float = 0.0
) -> tuple[np.ndarray, np.ndarray]:
    """Queries drawn from the corpus (the paper's word-similarity setup).
    Returns (queries, query_ids)."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(corpus.shape[0], size=n_queries, replace=False)
    q = corpus[ids].copy()
    if jitter > 0:
        q += jitter * rng.standard_normal(q.shape).astype(np.float32)
    return q, ids


WORD2VEC_LIKE = CorpusConfig(name="word2vec-like", alpha=0.3, mean_strength=0.6, seed=0)
GLOVE_LIKE = CorpusConfig(name="glove-like", alpha=0.4, mean_strength=0.9, seed=7)
