"""Memory-budget planner: pick the read-path encoding that fits (port of
``repro/core/memory_budget.py``; pure Python).

The quantized read path gives three memory/recall levers:

  * primary postings: fp32 (native store) | int8 | int4  -- match-stage bytes;
  * rerank store:     exact (fp32 originals) | int8 | none -- rerank bytes;
  * blockmax keep-fraction beta -- match-stage bytes actually streamed.

``plan_for_budget`` walks a recall-ordered frontier (best recall first) and
returns the first configuration whose resident bytes fit the budget, so a
caller states one number (``AnnIndex.build(..., memory_budget_bytes=)``)
and gets the most accurate read path that fits.  Knobs the caller pinned
are respected: the planner fills only the unset ones.  ``load_frontier``
re-orders the frontier from a measured ``BENCH_6.json``-style file.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.types import (
    BruteForceConfig,
    FakeWordsConfig,
    KdTreeConfig,
    LexicalLshConfig,
)

# Recall-ordered (best first) read-path configurations; keep_frac scales the
# blockmax keep count (1.0 = no pruning).  int8 postings sit above the
# pruned variants because per-doc-scale int8 keeps recall@10 within ~0.02 of
# fp32, while pruning costs recall directly.
DEFAULT_FRONTIER: Tuple[Dict, ...] = (
    dict(primary_postings="fp32", rerank_store="exact", keep_frac=1.0),
    dict(primary_postings="fp32", rerank_store="int8", keep_frac=1.0),
    dict(primary_postings="int8", rerank_store="int8", keep_frac=1.0),
    dict(primary_postings="int8", rerank_store="none", keep_frac=1.0),
    dict(primary_postings="int4", rerank_store="int8", keep_frac=1.0),
    dict(primary_postings="int4", rerank_store="none", keep_frac=1.0),
    dict(primary_postings="int4", rerank_store="none", keep_frac=0.5),
    dict(primary_postings="int4", rerank_store="none", keep_frac=0.25),
)


def postings_bytes_per_doc(config, dim: int, primary_postings: str, group: int = 32) -> int:
    """Resident match-stage bytes per document, as the builder stores them:
    fake-words classic keeps the int8 tf beside the packed store; dot int8
    IS the int8 tf; int4 packs two values per byte plus one f32 scale per
    ``group`` columns."""
    if isinstance(config, FakeWordsConfig):
        t = dim if config.signed_store else 2 * dim
        tf_b = t  # int8 tf
        if config.scoring == "classic":
            if primary_postings == "fp32":
                return tf_b + 2 * t  # bf16 scored
            if primary_postings == "int8":
                return tf_b + t + 4  # int8 rows + f32 per-doc scale
            return tf_b + _int4_bytes(t, group)
        if primary_postings == "int4":
            return _int4_bytes(t, group)
        return tf_b  # fp32 and int8 are both the int8 tf
    if isinstance(config, BruteForceConfig):
        if primary_postings == "fp32":
            return 4 * dim
        if primary_postings == "int8":
            return dim + 4
        return _int4_bytes(dim, group)
    if isinstance(config, (LexicalLshConfig, KdTreeConfig)):
        if primary_postings != "fp32":
            raise ValueError(f"{type(config).__name__} has no quantized primary postings")
        if isinstance(config, LexicalLshConfig):
            return 4 * config.hashes  # as the reference counts it (ROADMAP.md §C)
        return 4 * config.dims * 2  # reduced + lifted rows, as the reference counts them
    raise TypeError(f"unknown config {type(config)}")


def _int4_bytes(cols: int, group: int) -> int:
    tg = -(-cols // group) * group
    return tg // 2 + (tg // group) * 4  # packed nibbles + f32 group scales


def rerank_bytes_per_doc(dim: int, rerank_store: str) -> int:
    if rerank_store == "exact":
        return 4 * dim
    if rerank_store == "int8":
        return dim + 4
    return 0


def estimate_bytes(config, n_docs: int, dim: int, primary_postings: str = "fp32",
                   rerank_store: str = "exact", group: int = 32) -> int:
    """Resident bytes of the per-doc stores for a (postings, rerank) choice;
    the O(T) statistics (idf, df) are left out."""
    return n_docs * (postings_bytes_per_doc(config, dim, primary_postings, group)
                     + rerank_bytes_per_doc(dim, rerank_store))


def load_frontier(bench_path: str) -> List[Dict]:
    """Recall-ordered frontier from a measured benchmark file: its
    ``quantized_ab`` rows (recall desc) order the postings choices; the
    entries it did not sweep keep the default order."""
    with open(bench_path) as f:
        bench = json.load(f)
    measured = sorted(bench.get("quantized_ab", []), key=lambda r: -r["recall_at_10"])
    out: List[Dict] = []
    for r in measured:
        for entry in DEFAULT_FRONTIER:
            if entry["primary_postings"] == r["postings"] and entry not in out:
                out.append(entry)
    out += [entry for entry in DEFAULT_FRONTIER if entry not in out]
    return out


def plan_for_budget(
    config,
    n_docs: int,
    dim: int,
    budget_bytes: int,
    primary_postings: Optional[str] = None,
    rerank_store: Optional[str] = None,
    keep_frac: Optional[float] = None,
    group: int = 32,
    frontier: Optional[Sequence[Dict]] = None,
) -> Dict:
    """First frontier entry whose resident bytes fit ``budget_bytes``, best
    recall first, with ``estimated_bytes`` added.  Pinned knobs (not None)
    filter the frontier.  Raises with the smallest footprint when nothing
    fits.  ``keep_frac`` cuts bytes streamed, not resident bytes: it rides
    along with the entry chosen."""
    entries = list(frontier if frontier is not None else DEFAULT_FRONTIER)
    if isinstance(config, (LexicalLshConfig, KdTreeConfig)):
        entries = [e for e in entries if e["primary_postings"] == "fp32"]
    candidates = [
        e for e in entries
        if (primary_postings is None or e["primary_postings"] == primary_postings)
        and (rerank_store is None or e["rerank_store"] == rerank_store)
        and (keep_frac is None or e["keep_frac"] == keep_frac)
    ]
    if not candidates:
        raise ValueError(
            "no frontier entry matches the pinned knobs (primary_postings="
            f"{primary_postings}, rerank_store={rerank_store}, keep_frac={keep_frac})")
    best_short = None
    for e in candidates:
        cost = estimate_bytes(config, n_docs, dim, e["primary_postings"], e["rerank_store"],
                              group)
        if cost <= budget_bytes:
            return dict(e, estimated_bytes=cost)
        if best_short is None or cost < best_short:
            best_short = cost
    raise ValueError(
        f"memory budget {budget_bytes} bytes is below the smallest read path "
        f"({best_short} bytes) for this corpus; raise the budget or shrink the corpus")
