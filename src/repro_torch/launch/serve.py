"""End-to-end ANN serving launcher (port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --n-docs 100000 --queries 512
    PYTHONPATH=src python -m repro_torch.launch.serve --method lsh
    PYTHONPATH=src python -m repro_torch.launch.serve --method hnsw --ef 128
    PYTHONPATH=src python -m repro_torch.launch.serve --save-index /tmp/idx.ann
    PYTHONPATH=src python -m repro_torch.launch.serve --quantized-rerank
    PYTHONPATH=src python -m repro_torch.launch.serve --segments 8
    PYTHONPATH=src python -m repro_torch.launch.serve --qps 1000 --duration 10
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --n-docs 2048
    PYTHONPATH=src python -m repro_torch.launch.serve --shards 4

Builds an AnnIndex (fake words / lexical LSH / kd scan / brute force /
hnsw) over a synthetic word2vec-like corpus on ``--device`` (default the
card; it raises without one), stands up the batched :class:`AnnService`
over it, replays a query stream, and reports R@(k,d) against the exact
cosine top-k plus the service's own latency percentiles.  ``--save-index``
round-trips the index through ``AnnIndex.save`` / ``AnnIndex.load`` first.
``--quantized-rerank`` reranks from the int8 + per-doc scale store.

``--segments N`` ingests the corpus online through the ``IndexWriter``:
the service starts on the first chunk, the rest arrive between query
rounds through ``writer.add`` + ``service.refresh()``; 10% of the corpus is
then deleted and the index force-merged to one segment.  ``--qps`` runs an
open-loop generator against the async micro-batcher (Zipfian reuse, mixed
add / delete / search).  ``--shards N`` builds the index split over a
mesh of N shards (:func:`repro_torch.core.distributed.make_mesh` on
``--device``: round-robin over the visible cards, so on one card every
shard is on it) and serves every batch by fan-out and merge; it prints the
placement.
"""
from __future__ import annotations

import argparse
import collections
import queue as queue_mod
import time

import numpy as np
import torch

from repro_torch.core import bruteforce, distributed
from repro_torch.core import eval as ev
from repro_torch.core import plan as qplan
from repro_torch.core.index import AnnIndex, _check_device
from repro_torch.core.segments import IndexWriter
from repro_torch.core.types import (
    BruteForceConfig,
    FakeWordsConfig,
    GraphConfig,
    KdTreeConfig,
    LexicalLshConfig,
)
from repro_torch.data import embeddings
from repro_torch.serve.ann_service import AnnService, AnnServiceConfig


def make_config(args):
    if args.method == "fakewords":
        # df_max_ratio defaults OFF: on the dense synthetic corpora every
        # term exceeds df = 0.25 N, and a ratio of 0.25 zeroes every query.
        return FakeWordsConfig(quantization=args.q, df_max_ratio=args.df_max_ratio)
    if args.method == "lsh":
        return LexicalLshConfig(buckets=300, hashes=1)
    if args.method == "kdtree":
        return KdTreeConfig(dims=8, backend="scan")
    if args.method == "bruteforce":
        return BruteForceConfig()
    if args.method == "hnsw":
        return GraphConfig(ef=args.ef, beam=args.beam)
    raise ValueError(f"unknown method {args.method}")


def _recall(gt_i, ids) -> float:
    """R@k of ``ids`` against the ground truth's ids (any array-likes)."""
    return float(ev.recall_at(torch.as_tensor(np.asarray(gt_i)),
                              torch.as_tensor(np.asarray(ids))))


def _exact_ids(corpus: np.ndarray, queries: np.ndarray, k: int, dev) -> np.ndarray:
    """The exact cosine top-k ids of ``queries`` over ``corpus`` on ``dev``."""
    _, gt_i = bruteforce.exact_topk(torch.as_tensor(corpus, device=dev),
                                    torch.as_tensor(queries, device=dev), k)
    return gt_i.cpu().numpy()


def serve_segmented(args, corpus, queries) -> dict:
    """Online-ingestion serving loop: start on the first chunk, stream the
    rest through ``writer.add`` + ``service.refresh()`` between query
    rounds, then delete 10% and force-merge; recall against the final live
    corpus."""
    rng = np.random.default_rng(0)
    config = make_config(args)
    writer = IndexWriter(config, rerank_store="int8" if args.quantized_rerank else "exact",
                         primary_postings=args.postings or "fp32", device=args.device)
    chunks = np.array_split(np.asarray(corpus), args.segments)
    t0 = time.time()
    writer.add(chunks[0])
    svc = AnnService(writer=writer, service=AnnServiceConfig(
        k=args.k, depth=args.depth, rerank=args.rerank, max_batch=args.batch, cache_size=64))
    svc.search_batch(queries[: args.batch])  # warm-up (kernel builds, captures)
    svc.reset_latency()
    for chunk in chunks[1:]:
        writer.add(chunk)
        svc.refresh()
        svc.search_batch(queries[: args.batch])  # serve between ingests
    ingest_s = time.time() - t0
    dead = rng.choice(args.n_docs, size=args.n_docs // 10, replace=False)
    writer.delete(dead)
    svc.refresh()
    n_seg_before = svc.ann.num_segments
    ids_all = np.concatenate([svc.search_batch(queries[i : i + args.batch])[1]
                              for i in range(0, len(queries), args.batch)])
    # Ground truth over the LIVE corpus, mapped to stable global ids.
    live = np.ones(args.n_docs, bool)
    live[dead] = False
    gmap = svc.ann.live_global_ids()
    gt_global = gmap[_exact_ids(np.asarray(corpus)[live], queries, args.k, args.device)]
    recall = _recall(gt_global, ids_all)
    t1 = time.time()
    writer.force_merge(1)
    svc.refresh()
    merge_s = time.time() - t1
    stats = svc.stats()
    out = {
        "method": svc.ann.method,
        "recall@k": round(recall, 4),
        "p50_ms_per_batch": stats["lat_p50_ms"],
        "p99_ms_per_batch": stats["lat_p99_ms"],
        "segments_before_merge": n_seg_before,
        "merge_s": round(merge_s, 2),
        "ingest_s": round(ingest_s, 2),
        "live_docs": stats["num_docs"],
        "epoch": stats["epoch"],
        "cache": (stats["cache_hits"], stats["cache_misses"]),
    }
    print(f"[serve] segmented NRT {out}")
    return out


def zipf_sampler(rng, pool: int, s: float):
    """Zipfian rank-frequency sampler over a query pool: real query streams
    are head-skewed, which is what makes result caches and micro-batch
    coalescing pay."""
    ranks = np.arange(1, pool + 1, dtype=np.float64)
    p = ranks ** -s
    p /= p.sum()
    return lambda n: rng.choice(pool, size=n, p=p)


def sequential_qps(svc: AnnService, pool_q: np.ndarray, order) -> float:
    """Queries a second served one at a launch (each padded to the
    service's ``max_batch``), in the order of the pool indices ``order``."""
    t0 = time.perf_counter()
    for i in order:
        svc.search_batch(pool_q[int(i) : int(i) + 1])
    return len(order) / (time.perf_counter() - t0)


def open_loop(svc: AnnService, pool_q: np.ndarray, sample, qps: float, duration: float,
              mutate_every: int = 0, mutate=None):
    """Submit single queries from ``pool_q`` (indices drawn by ``sample``)
    to the started async service on a fixed wall-clock schedule: ``qps``
    arrivals a second for ``duration`` seconds, never waiting for results.
    Every arrival of the schedule is submitted, late when this thread falls
    behind it; a full admission queue sheds the arrival.  Every
    ``mutate_every`` sent requests ``mutate()`` runs on this thread.
    Returns (futures, sent, shed, seconds until every future resolved, the
    largest lag behind the schedule in seconds)."""
    period = 1.0 / qps
    futs, shed, sent, lag = [], 0, 0, 0.0
    start = time.perf_counter()
    for j in range(int(round(qps * duration))):
        due = start + j * period
        now = time.perf_counter()
        while now < due:
            time.sleep(min(due - now, 1e-3))
            now = time.perf_counter()
        lag = max(lag, now - due)
        i = int(sample(1)[0])
        try:
            futs.append(svc.search_async(pool_q[i]))
            sent += 1
        except queue_mod.Full:
            shed += 1
        if mutate_every and sent and sent % mutate_every == 0:
            mutate()
    for f in futs:
        f.result(timeout=120)
    return futs, sent, shed, time.perf_counter() - start, lag


def serve_openloop(args, corpus, queries) -> dict:
    """Open-loop traffic: arrivals on a FIXED ``--qps`` schedule (whatever
    the service's speed), Zipfian reuse over a query pool, and mixed add /
    delete / search against the NRT writer.  Reports sustained QPS and
    per-request p50 / p99 of the async micro-batcher beside a sequential
    one-query-a-launch A/B over the same stream."""
    rng = np.random.default_rng(13)
    config = make_config(args)
    writer = IndexWriter(config, rerank_store="int8" if args.quantized_rerank else "exact",
                         primary_postings=args.postings or "fp32", device=args.device)
    n0 = max(args.batch, int(args.n_docs * 0.9))
    corpus = np.asarray(corpus)
    writer.add(corpus[:n0])
    ingest_ptr = [n0]
    svc = AnnService(writer=writer, service=AnnServiceConfig(
        k=args.k, depth=args.depth, rerank=args.rerank, max_batch=args.batch,
        max_wait_s=args.max_wait_ms / 1e3, queue_depth=args.queue_depth))
    pool = min(args.query_pool, len(queries))
    pool_q = np.asarray(queries)[:pool]
    sample = zipf_sampler(rng, pool, args.zipf_s)
    svc.search_batch(pool_q[: args.batch])  # warm-up (kernel builds, captures)
    svc.reset_latency()
    seq_qps = sequential_qps(svc, pool_q, sample(max(32, min(512, int(args.qps * args.duration
                                                                       / 4)))))
    svc.reset_latency()

    def mutate():
        """Mixed workload: ingest a small chunk, delete a few docs, refresh."""
        if ingest_ptr[0] < len(corpus):
            writer.add(corpus[ingest_ptr[0] : ingest_ptr[0] + 32])
            ingest_ptr[0] += 32
        writer.delete(rng.choice(ingest_ptr[0], size=4, replace=False))
        svc.refresh()

    svc.start_async()
    futs, sent, shed, elapsed, lag = open_loop(svc, pool_q, sample, args.qps, args.duration,
                                               args.mutate_every, mutate)
    svc.stop_async()
    stats = svc.stats()
    out = {
        "method": svc.ann.method,
        "offered_qps": args.qps,
        "sustained_qps": round(len(futs) / elapsed, 1),
        "sequential_qps": round(seq_qps, 1),
        "req_p50_ms": stats["req_p50_ms"],
        "req_p99_ms": stats["req_p99_ms"],
        "async_launches": stats["async_launches"],
        "batch_per_launch": round(len(futs) / max(1, stats["async_launches"]), 1),
        "sent": sent,
        "shed": shed,
        "max_lag_ms": round(lag * 1e3, 1),
        "live_docs": stats["num_docs"],
        "segments": stats["segments"],
    }
    print(f"[serve] open-loop {out}")
    return out


def serve_filtered(args, svc, corpus, queries, ratios, unfiltered) -> list:
    """Filtered smoke: the same query stream under random keep bitmaps at
    each selectivity, masked inside the match stage; recall against the
    exact top-k over the FILTERED corpus, latency beside the unfiltered
    replay's."""
    rng = np.random.default_rng(7)
    results = []
    for ratio in ratios:
        mask = rng.random(args.n_docs) < ratio
        if mask.sum() < args.k:  # degenerate draw at tiny selectivity
            mask[rng.choice(args.n_docs, size=args.k, replace=False)] = True
        filt = mask.astype(np.int32)
        svc.search_batch(queries[: args.batch], filter=filt)  # warm-up
        svc.reset_latency()
        ids_all = np.concatenate([
            svc.search_batch(queries[i : i + args.batch], filter=filt)[1]
            for i in range(0, len(queries), args.batch)])
        kept = np.flatnonzero(mask)
        gt_global = kept[_exact_ids(np.asarray(corpus)[kept], queries, args.k, args.device)]
        stats = svc.stats()
        row = {
            "selectivity": ratio,
            "recall@k": round(_recall(gt_global, ids_all), 4),
            "p50_ms_per_batch": stats["lat_p50_ms"],
            "p99_ms_per_batch": stats["lat_p99_ms"],
        }
        results.append(row)
        print(f"[serve] filtered {ratio:.0%}: recall@k {row['recall@k']} "
              f"p50 {row['p50_ms_per_batch']}ms p99 {row['p99_ms_per_batch']}ms"
              f" (unfiltered: p50 {unfiltered['p50_ms_per_batch']}ms "
              f"p99 {unfiltered['p99_ms_per_batch']}ms)")
    return results


def serve_hybrid(args, ann, corpus, queries) -> dict:
    """Hybrid smoke: RRF-fuse a lexical classic fake-words retriever with a
    dense kd-scan retriever over the same corpus (``core/plan.py``
    FusionStage); recall@k of the fusion beside each retriever alone."""
    cv = torch.as_tensor(np.asarray(corpus), device=args.device)
    lex = (ann if isinstance(ann.config, FakeWordsConfig) and ann.config.scoring == "classic"
           else AnnIndex.build(cv, FakeWordsConfig(quantization=args.q), device=args.device))
    dense = AnnIndex.build(cv, KdTreeConfig(dims=8, backend="scan"), device=args.device)
    sub = {
        "classic": qplan.QueryPlan(search=lambda q: lex.search(q, k=args.k, depth=args.depth),
                                   label="classic"),
        "dense": qplan.QueryPlan(search=lambda q: dense.search(q, k=args.k, depth=args.depth),
                                 label="dense"),
    }
    fusion = qplan.FusionStage(plans=tuple(sub.values()), k=args.k)
    qv = torch.as_tensor(np.asarray(queries), device=args.device)
    gt = _exact_ids(np.asarray(corpus), np.asarray(queries), args.k, args.device)
    rec = {name: round(_recall(gt, p.run(qv)[1].cpu().numpy()), 4) for name, p in sub.items()}
    rec["hybrid_rrf"] = round(_recall(gt, fusion.run(qv)[1].cpu().numpy()), 4)
    print(f"[serve] hybrid recall@{args.k}: classic {rec['classic']} "
          f"dense {rec['dense']} rrf {rec['hybrid_rrf']}")
    return rec


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-docs", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=300)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--method", choices=("fakewords", "lsh", "kdtree", "bruteforce", "hnsw"),
                    default="fakewords")
    ap.add_argument("--q", type=int, default=50, help="fake-words quantization")
    ap.add_argument("--ef", type=int, default=64,
                    help="hnsw search list width (recall/latency knob)")
    ap.add_argument("--beam", type=int, default=4,
                    help="hnsw nodes expanded per traversal iteration")
    ap.add_argument("--df-max-ratio", type=float, default=1.0,
                    help="search-time high-df term filtering (1.0 = off)")
    ap.add_argument("--depth", type=int, default=100)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--rerank", action="store_true", default=True)
    ap.add_argument("--blockmax-keep", type=int, default=None)
    ap.add_argument("--shards", type=int, default=0,
                    help="build THROUGH the sharded BuildPipeline over a mesh of this many "
                         "shards (round-robin over the visible cards of --device) and serve "
                         "by fan-out + merge")
    ap.add_argument("--save-index", default=None,
                    help="save the built index here and serve from the loaded copy")
    ap.add_argument("--quantized-rerank", action="store_true",
                    help="rerank from the int8 + per-doc-scale store instead of the fp32 "
                         "originals (~4x fewer rerank gather bytes)")
    ap.add_argument("--postings", choices=("fp32", "int8", "int4"), default=None,
                    help="primary postings encoding: int8 (per-doc scale) or int4 (grouped "
                         "scales), dequantized inside the fused score stage; default fp32 "
                         "unless --memory-budget picks otherwise")
    ap.add_argument("--memory-budget", type=float, default=None, metavar="MB",
                    help="resident index budget in MB; picks the best-recall {postings, "
                         "rerank store, blockmax keep} that fits (core/memory_budget.py); "
                         "knobs set explicitly are pinned")
    ap.add_argument("--segments", type=int, default=0,
                    help="ingest the corpus ONLINE in this many chunks through the IndexWriter "
                         "(segmented NRT serving with deletes + a forced merge)")
    ap.add_argument("--filter-ratio", type=float, nargs="*", default=None, metavar="RATIO",
                    help="filtered-search smoke: replay the query stream under random "
                         "predicate bitmaps at these selectivities (bare flag = "
                         "1%%/10%%/50%%), logging filtered p50/p99 and recall next to the "
                         "unfiltered numbers")
    ap.add_argument("--qps", type=float, default=0,
                    help="open-loop traffic generator: submit single queries to the async "
                         "micro-batcher at this fixed arrival rate (Zipfian reuse over "
                         "--query-pool, mixed add/delete/search via --mutate-every) and "
                         "report sustained QPS + per-request p50/p99 next to a sequential "
                         "single-query A/B")
    ap.add_argument("--duration", type=float, default=5.0,
                    help="open-loop run length in seconds")
    ap.add_argument("--query-pool", type=int, default=256,
                    help="distinct queries in the Zipfian reuse pool")
    ap.add_argument("--zipf-s", type=float, default=1.1,
                    help="Zipf skew exponent for query reuse")
    ap.add_argument("--mutate-every", type=int, default=200,
                    help="every N requests: add a 32-doc chunk, delete 4 docs, refresh "
                         "(0 = search-only traffic)")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="async micro-batch window (the SLO's donation)")
    ap.add_argument("--queue-depth", type=int, default=256,
                    help="async admission queue bound (backpressure)")
    ap.add_argument("--hybrid", action="store_true",
                    help="hybrid smoke: RRF-fuse the lexical classic fake-words retriever with "
                         "a dense kd-scan retriever over the same corpus (core/plan.py "
                         "FusionStage) and log recall@k of the fusion next to each retriever "
                         "alone")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the index and the search (default the card; "
                         "raises without one)")
    args = ap.parse_args(argv)
    _check_device(args.device)

    corpus = embeddings.make_corpus(embeddings.CorpusConfig(n_vectors=args.n_docs, dim=args.dim))
    queries, _ = embeddings.make_queries(corpus, args.queries)

    if args.qps:
        if args.segments:
            raise SystemExit("--qps drives the async NRT writer path; it is not combined "
                             "with --segments")
        return serve_openloop(args, corpus, queries)

    if args.segments:
        if args.shards:
            raise SystemExit("--segments and --shards are mutually exclusive")
        if args.filter_ratio is not None or args.hybrid:
            raise SystemExit("--filter-ratio/--hybrid smoke modes run on the monolithic "
                             "serving path; drop --segments")
        if args.save_index:
            raise SystemExit("--segments persists via IndexWriter.commit, not --save-index; "
                             "use writer.commit(path) / SegmentedAnnIndex.load(path)")
        if args.memory_budget is not None:
            raise SystemExit("--memory-budget plans a monolithic build; with --segments pass "
                             "--postings/--quantized-rerank explicitly")
        return serve_segmented(args, corpus, queries)

    mesh = None
    if args.shards:
        if args.method == "hnsw":
            raise SystemExit(
                "--shards serves shard-local match + merge, which graph traversal cannot do "
                "(adjacency edges cross shard boundaries); serve hnsw with --segments N or "
                "single-device (the sharded BUILD is supported: distributed.build_sharded)")
        mesh = distributed.make_mesh((args.shards,), ("data",), device=args.device)
        placement = collections.Counter(str(d) for d in mesh.devices)
        print(f"[serve] mesh: {args.shards} shards over {len(placement)} device(s) "
              f"({', '.join(f'{d} x{n}' for d, n in sorted(placement.items()))})")

    config = make_config(args)
    rerank_store = "int8" if args.quantized_rerank else (
        None if args.memory_budget is not None else "exact")
    budget = int(args.memory_budget * 1e6) if args.memory_budget is not None else None
    t0 = time.time()
    ann = AnnIndex.build(corpus, config, rerank_store=rerank_store,
                         primary_postings=args.postings, memory_budget_bytes=budget,
                         device=args.device, mesh=mesh, shard_axes=("data",))
    _sync(args.device)
    build_s = time.time() - t0
    if mesh is not None:
        # One process builds every shard: on one card this is the total of
        # the shards' builds, which run one after another.
        print(f"[serve] sharded build: {args.shards} shards x {args.n_docs // args.shards} "
              f"docs, build wall time {build_s:.2f}s (no full-corpus copy on a shard)")
    print(f"[serve] indexed {args.n_docs} docs ({ann.method}"
          f"{', int8 rerank store' if args.quantized_rerank else ''}) "
          f"in {build_s:.1f}s ({ann.nbytes()/1e6:.0f} MB)")

    if args.save_index:
        ann.save(args.save_index)
        ann = AnnIndex.load(args.save_index, device=args.device)
        print(f"[serve] round-tripped index through {args.save_index}")

    # A budget plan may select rerank_store="none"; serving then runs
    # match-only whatever --rerank says.
    local = distributed.first_shard(ann.index)
    do_rerank = args.rerank and (local.vectors is not None
                                 or getattr(local, "vq", None) is not None)
    svc = AnnService(ann, AnnServiceConfig(k=args.k, depth=args.depth, rerank=do_rerank,
                                           max_batch=args.batch,
                                           blockmax_keep=args.blockmax_keep),
                     mesh=mesh, shard_axes=("data",) if mesh is not None else ())

    # Warm-up (kernel builds, graph captures), then the timed replay.
    svc.search_batch(queries[: args.batch])
    svc.reset_latency()
    ids_all = np.concatenate([svc.search_batch(queries[i : i + args.batch])[1]
                              for i in range(0, len(queries), args.batch)])
    recall = _recall(_exact_ids(corpus, queries, args.k, args.device), ids_all)
    stats = svc.stats()
    out = {
        "method": ann.method,
        "recall@k": round(recall, 4),
        "p50_ms_per_batch": stats["lat_p50_ms"],
        "p99_ms_per_batch": stats["lat_p99_ms"],
        "index_mb": round(ann.nbytes() / 1e6, 1),
        "queries": int(svc.queries_served),
    }
    print(f"[serve] {out}")

    if args.filter_ratio is not None:
        ratios = args.filter_ratio if args.filter_ratio else [0.01, 0.1, 0.5]
        out["filtered"] = serve_filtered(args, svc, corpus, queries, ratios, out)
    if args.hybrid:
        out["hybrid"] = serve_hybrid(args, ann, corpus, queries)
    return out


if __name__ == "__main__":
    main()
