"""Quickstart on the PyTorch port: ANN search on dense vectors through the
writer API.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cuda|cpu] [--docs N]

The port's counterpart of ``examples/quickstart.py``.  Feeds a synthetic
word2vec-like corpus through the Lucene-style ``IndexWriter`` for the three
paper encodings, the proximity graph and the exact brute-force oracle:
``add`` buffers rows, ``refresh()`` returns a searchable near-real-time
reader, and every reader searches through the staged pipeline (encode ->
match -> exact rerank).  Prints R@(10,d) against the oracle (a miniature of
the paper's Table 1), then walks the segment lifecycle (adds, deletes, a
generation-numbered ``commit``, reload, a forced merge), asserting the
segmented index stays bit-for-bit identical to a fresh monolithic build of
the live corpus; then the quantized read path under a memory budget,
filtered kNN from a ``DocMetadata`` predicate, hybrid retrieval through
``plan.FusionStage`` (reciprocal-rank fusion), and the graph served through
``AnnService``.  Runs on the card by default (the hand-written kernels);
``--device cpu`` runs their plain versions.
"""
import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch

from repro_torch.core import bruteforce, plan
from repro_torch.core import eval as ev
from repro_torch.core.index import AnnIndex
from repro_torch.core.segments import IndexWriter, SegmentedAnnIndex
from repro_torch.core.types import (
    BruteForceConfig,
    FakeWordsConfig,
    GraphConfig,
    KdTreeConfig,
    LexicalLshConfig,
    SearchParams,
)
from repro_torch.data import embeddings
from repro_torch.serve.ann_service import AnnService, AnnServiceConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--docs", type=int, default=20_000)
    args = ap.parse_args(argv)
    dev, n_docs = args.device, args.docs
    print(f"== corpus: {n_docs} synthetic word2vec-like vectors (300-d) on {dev}")
    corpus_np = embeddings.make_corpus(
        dataclasses.replace(embeddings.WORD2VEC_LIKE, n_vectors=n_docs))
    queries_np, _ = embeddings.make_queries(corpus_np, 64)
    corpus = torch.from_numpy(corpus_np).to(dev)
    queries = torch.from_numpy(queries_np).to(dev)
    _, gt = bruteforce.exact_topk(corpus, queries, 10)

    for cfg in [
        FakeWordsConfig(quantization=50),                 # best (paper)
        LexicalLshConfig(buckets=300, hashes=1),          # middle
        KdTreeConfig(dims=8, reduction="pca"),            # fast, collapsed
        GraphConfig(ef=128, beam=16, iters=12),           # the proximity graph
        BruteForceConfig(),                               # the oracle itself
    ]:
        writer = IndexWriter(cfg, device=dev)
        writer.add(corpus_np)
        idx = writer.refresh()  # NRT reader over the flushed segment
        _, ids = idx.search(queries, params=SearchParams(k=100, depth=100))
        r10 = float(ev.recall_at(gt, ids[:, :10]))
        r100 = float(ev.recall_at(gt, ids))
        # two-phase: depth-100 match + exact rerank (the refinement step)
        _, ids_rr = idx.search(queries, params=SearchParams(k=10, depth=100, rerank=True))
        r_rr = float(ev.recall_at(gt, ids_rr))
        print(f"{idx.method:12s} R@(10,10)={r10:.3f} R@(10,100)={r100:.3f} "
              f"rerank@100->10={r_rr:.3f} index={idx.nbytes() / 1e6:.0f}MB")

    # The segment lifecycle: ingest-while-serving, deletes, commit, merge.
    cfg = FakeWordsConfig(quantization=50)
    split = n_docs // 2
    writer = IndexWriter(cfg, device=dev)
    writer.add(corpus_np[:split])
    writer.flush()                      # segment 1
    writer.add(corpus_np[split:])       # segment 2 (flushed by refresh)
    writer.delete(np.arange(0, n_docs, 10))  # kill every 10th doc
    reader = writer.refresh()
    print(f"segments={reader.num_segments} live={reader.num_docs} "
          f"deleted={reader.del_count} epoch={reader.epoch}")

    # Bit-for-bit parity with a fresh monolithic build of the live corpus.
    live = np.ones(n_docs, bool)
    live[::10] = False
    mono = AnnIndex.build(corpus_np[live], cfg, device=dev)
    s_seg, i_seg = reader.search(queries, k=10, depth=100, rerank=True)
    s_mono, i_mono = mono.search(queries, k=10, depth=100, rerank=True)
    gmap = reader.live_global_ids()  # monolithic id j <-> gmap[j]
    assert (gmap[i_mono.cpu().numpy()] == i_seg.cpu().numpy()).all()
    assert torch.equal(s_mono, s_seg)
    print("segmented == monolithic live-corpus build: bit-for-bit")

    # Commit points are durable and generation-numbered; merges compact.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fakewords.ann")
        gen = writer.commit(path)
        writer.force_merge(1)           # drop deletes, remap ids
        gen2 = writer.commit()
        loaded = SegmentedAnnIndex.load(path, device=dev)  # latest generation
        _, i2 = loaded.search(queries, k=10, depth=100, rerank=True)
        assert torch.equal(i2, i_mono)  # merged == monolithic
        old = SegmentedAnnIndex.load(path, generation=gen, device=dev)  # point in time
        print(f"commit gens {gen}->{gen2}: merged reload identical to the monolithic build; "
              f"gen {gen} still readable ({old.num_segments} segments, "
              f"{old.del_count} deletes)")

    # The quantized read path under a memory budget: one resident-bytes
    # number, and the planner picks the best-recall postings x rerank store
    # that fits (here ~3x below the fp32 + exact footprint).
    full = AnnIndex.build(corpus, cfg, device=dev)
    budget = int(full.nbytes() / 3)
    ann_q = AnnIndex.build(corpus, cfg, memory_budget_bytes=budget, device=dev)
    can_rerank = ann_q.index.vectors is not None or ann_q.index.vq is not None
    _, ids_q = ann_q.search(queries, params=SearchParams(k=10, depth=100, rerank=can_rerank))
    r_q = float(ev.recall_at(gt, ids_q))
    store = f"int{ann_q.index.pq.bits}" if ann_q.index.pq is not None else "fp32"
    print(f"memory_budget_bytes={budget / 1e6:.1f}MB -> {store} postings, "
          f"{ann_q.nbytes() / 1e6:.1f}MB resident ({full.nbytes() / 1e6:.1f}MB unquantized), "
          f"R@10={r_q:.3f}")

    # Filtered kNN: per-doc metadata at build time, a predicate bitmap, and
    # a search WITH it: the mask is applied inside the match stage.
    year = np.random.default_rng(3).integers(2000, 2020, n_docs)
    ann_f = AnnIndex.build(corpus, cfg, metadata={"year": year}, device=dev)
    fmask = ann_f.metadata.range_mask("year", 2010, 2020)  # ~half the docs
    _, ids_f = ann_f.search(queries, k=10, depth=100, filt=fmask)
    kept = torch.nonzero(fmask.bool().to(dev))[:, 0]
    _, gt_f = bruteforce.exact_topk(corpus[kept], queries, 10)
    r_f = float(ev.recall_at(kept[gt_f.long()].to(torch.int32), ids_f))
    got = ids_f.cpu().numpy()
    assert (year[got[got >= 0]] >= 2010).all()  # the predicate honoured exactly
    print(f"filtered search (year >= 2010, {kept.numel()}/{n_docs} docs): R@10={r_f:.3f} "
          f"vs the filtered oracle")

    # Hybrid retrieval: RRF-fuse classic fake words (~ lexical) and dot int8
    # (~ dense inner product), which make different mistakes.
    dense = AnnIndex.build(corpus, FakeWordsConfig(quantization=50, scoring="dot"), device=dev)
    fusion = plan.FusionStage(plans=(
        plan.QueryPlan(search=lambda q: ann_f.search(q, k=30, depth=100), label="classic"),
        plan.QueryPlan(search=lambda q: dense.search(q, k=30, depth=100), label="dot"),
    ), k=10)
    _, ids_h = fusion.run(queries)
    r_lex = float(ev.recall_at(gt, ann_f.search(queries, k=10, depth=100)[1]))
    r_den = float(ev.recall_at(gt, dense.search(queries, k=10, depth=100)[1]))
    r_rrf = float(ev.recall_at(gt, ids_h))
    print(f"hybrid RRF(classic, dot) R@10={r_rrf:.3f} (classic {r_lex:.3f}, dot {r_den:.3f})")

    # The graph encoding served through the same AnnService as every encoding.
    g = AnnIndex.build(corpus, GraphConfig(ef=128, beam=16, iters=12), device=dev)
    svc = AnnService(g, AnnServiceConfig(k=10, depth=10, rerank=False))
    _, ids_g = svc.search_batch(queries_np)
    r_g = float(ev.recall_at(gt.cpu(), torch.from_numpy(ids_g)))
    print(f"hnsw served through AnnService: R@10={r_g:.3f} (adjacency "
          f"{tuple(g.index.neighbors.shape)}, entries {g.index.entry.tolist()})")


if __name__ == "__main__":
    main()
