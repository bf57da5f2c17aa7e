"""Staged index construction (port of ``repro/core/builder.py``):

    normalize rows -> transform vectors (tf rows / MinHash signatures / identity)
                   -> assemble postings (index container + global stats)
                   -> attach rerank store (fp32 originals / none)

Each stage is a frozen dataclass; :class:`BuildPipeline` runs them on the
device of the vectors it is given.  Only fp32 primary postings and the
exact / no rerank stores are ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import torch

from repro_torch.core import bruteforce, fakewords, lexical_lsh
from repro_torch.core.types import (
    BruteForceConfig,
    FakeWordsConfig,
    FakeWordsIndex,
    FlatIndex,
    LexicalLshConfig,
    LshIndex,
)

AnyConfig = Union[FakeWordsConfig, LexicalLshConfig, BruteForceConfig]

RERANK_STORES = ("exact", "int8", "none")
PRIMARY_POSTINGS = ("fp32", "int8", "int4")


# --------------------------------------------------------------------------
# Vector transforms
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TfTransform:
    """Fake words: sign-split quantized term-frequency rows."""

    config: FakeWordsConfig

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return fakewords.encode(v, self.config.quantization, self.config.store_dtype)


@dataclasses.dataclass(frozen=True)
class MinHashTransform:
    """Lexical LSH: MinHash signatures (row-local)."""

    config: LexicalLshConfig

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return lexical_lsh.encode(v, self.config)


@dataclasses.dataclass(frozen=True)
class IdentityTransform:
    """Brute force: the unit-normalized rows themselves."""

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return v


# --------------------------------------------------------------------------
# Postings assembly
# --------------------------------------------------------------------------


def live_df(tf: torch.Tensor, live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-term document frequency over the (optionally live-masked) rows."""
    present = tf > 0
    if live is not None:
        present = present & live[:, None]
    return present.sum(0, dtype=torch.int32)


def idf_from_df(df: torch.Tensor, n_total: int) -> torch.Tensor:
    """Lucene ClassicSimilarity idf = 1 + ln(N / (df + 1)), float32."""
    return 1.0 + torch.log(n_total / (df.to(torch.float32) + 1.0))


def classic_scored(tf: torch.Tensor, idf: torch.Tensor, norm: torch.Tensor) -> torch.Tensor:
    """Per-(doc, term) classic scoring matrix sqrt(tf_d) * idf^2 * norm_d in
    bf16, so query scoring is one product."""
    tf_f = tf.to(torch.float32)
    return (torch.sqrt(tf_f) * (idf**2)[None, :] * norm[:, None]).to(torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class FakeWordsPostings:
    """df / idf / norm statistics + the precomputed classic scoring matrix."""

    config: FakeWordsConfig

    def __call__(self, tf: torch.Tensor, v: torch.Tensor, store: dict,
                 n_total: int) -> FakeWordsIndex:
        df = live_df(tf)
        idf = idf_from_df(df, n_total)
        doc_len = tf.to(torch.float32).sum(-1)
        norm = torch.rsqrt(torch.clamp_min(doc_len, 1.0))
        scored = classic_scored(tf, idf, norm) if self.config.scoring == "classic" else None
        return FakeWordsIndex(tf=tf, idf=idf, norm=norm, df=df, scored=scored, **store)


@dataclasses.dataclass(frozen=True)
class LshPostings:
    """Signatures carry their own statistics: pure container assembly."""

    def __call__(self, sig: torch.Tensor, v: torch.Tensor, store: dict,
                 n_total: int) -> LshIndex:
        return LshIndex(sig=sig, **store)


@dataclasses.dataclass(frozen=True)
class FlatPostings:
    """Brute force: the normalized rows are the match operand."""

    def __call__(self, rep: torch.Tensor, v: torch.Tensor, store: dict,
                 n_total: int) -> FlatIndex:
        return FlatIndex(vectors=v)


# --------------------------------------------------------------------------
# Rerank stores
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ExactRerankStore:
    """Keep the fp32 unit-normalized originals."""

    def __call__(self, v: torch.Tensor) -> dict:
        return {"vectors": v}


@dataclasses.dataclass(frozen=True)
class NoRerankStore:
    """No rerank operand (rerank=True will fail)."""

    def __call__(self, v: torch.Tensor) -> dict:
        return {"vectors": None}


_STORES = {"exact": ExactRerankStore(), "none": NoRerankStore()}


# --------------------------------------------------------------------------
# The pipeline
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BuildPipeline:
    """normalize -> transform -> postings -> rerank store."""

    config: AnyConfig
    transform: Any
    postings: Any
    store: Any = ExactRerankStore()

    def build_local(self, vectors: torch.Tensor, normalized: bool = False):
        """Build on the device ``vectors`` lies on."""
        v = vectors if normalized else bruteforce.l2_normalize(vectors)
        return self.postings(self.transform(v), v, self.store(v), v.shape[0])


def make_build_pipeline(
    config: AnyConfig,
    rerank_store: str = "exact",
    primary_postings: str = "fp32",
) -> BuildPipeline:
    """Every method is a stage configuration.  ``rerank_store``: "exact" |
    "none" ("int8" is not ported yet); ``primary_postings``: "fp32" ("int8"
    and "int4" are not ported yet)."""
    if rerank_store not in RERANK_STORES:
        raise ValueError(f"rerank_store must be one of {RERANK_STORES}, got {rerank_store!r}")
    if primary_postings not in PRIMARY_POSTINGS:
        raise ValueError(
            f"primary_postings must be one of {PRIMARY_POSTINGS}, got {primary_postings!r}")
    if rerank_store == "int8" or primary_postings != "fp32":
        raise NotImplementedError(
            "quantized postings and the int8 rerank store are not ported yet "
            "(ROADMAP.md, queue A: quantized read path)")
    store = _STORES[rerank_store]
    if isinstance(config, FakeWordsConfig):
        return BuildPipeline(config, TfTransform(config), FakeWordsPostings(config), store)
    if isinstance(config, LexicalLshConfig):
        return BuildPipeline(config, MinHashTransform(config), LshPostings(), store)
    if isinstance(config, BruteForceConfig):
        return BuildPipeline(config, IdentityTransform(), FlatPostings(), store)
    raise TypeError(f"config {type(config).__name__} is not ported yet (ROADMAP.md, queue A)")
