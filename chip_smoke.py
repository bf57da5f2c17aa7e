#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

1. Builds the CUDA kernels from ``src/repro_torch/kernels/*/csrc`` with nvcc
   (sm_90a) and prints the build time and the compiler's register report.
2. Holds the fused top-k kernel (K1/K2) against its plain PyTorch version on
   the card in all four score modes (bf16, f32, int8, lsh), with unaligned
   shapes, ragged ``n_docs``, depth = N under massive ties, and ``filt``.
3. Holds the gathered fused top-k kernel (K3) against its plain version the
   same way, with row ids in random order and in 256-row blocks, padding
   ids, ``filt``, and B = 1 over ~300k rows.
4. Runs the ann-word2vec deployment (2,999,808 x 300, classic fake words,
   B = 256, depth 100, k 10) end to end through ``AnnIndex.build`` /
   ``search`` on the card, with the exact-cosine ground truth, and checks
   recall, the rerank identity and that the kernel carried the path.
5. Runs blockmax pruning on that index (10% and 25% of the 256-row blocks
   kept) through the facade, with recalls, and at every block kept holds
   classic, dot and lsh blockmax against the dense searches.
6. Builds the lexical-LSH index (b = 300, h = 1) of the same corpus and
   searches it at B = 256 on K1's lsh mode (K2), with recall.
7. Times build, searches (B = 256, 8 and 1), and each kernel beside its
   bound, its plain version and a library yardstick, with CUDA events
   (median of 10 runs after a warm-up).

Exits non-zero on any failure, or when no CUDA device is available.  The
last two lines are a JSON object of per-kernel numbers and the JSON status
line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a call
# is the larger of bytes / memory rate and operations / peak rate.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {
    "bf16": 989e12, "f32": 67e12, "int8": 1979e12,
    # INT32 (the lsh compare): 64 INT32 lanes per SM (Hopper architecture
    # white paper) x 132 SMs x 1.98 GHz boost clock.
    "int32": 16.7e12,
}
TOL = 1e-5  # rtol = atol for float scores
RUNS = 10
BLOCK = 256  # blockmax block size
KEEP_FRACTIONS = (0.10, 0.25)  # of the blocks: 1171 and 2929 of 11,718 at full size


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int = RUNS, warmup: int = 2) -> float:
    """Median device time of ``fn`` over ``runs`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound(nbytes: float, ops: float, kind: str):
    """(least time in ms, "bytes" | "operations"): the larger of bytes over
    the memory rate and operations over the peak rate of ``kind``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_ms(q, docs, n_docs: int, depth: int, kind: str):
    """Bound of one fused top-k call: each input read once, each output
    written once; 2*B*N*T operations (B*N*S compares in lsh mode)."""
    b, t = q.shape
    nbytes = (q.numel() * q.element_size() + n_docs * t * docs.element_size()
              + b * depth * 8)
    ops = (1.0 if kind == "int32" else 2.0) * b * n_docs * t
    return _bound(nbytes, ops, kind)


def gathered_bound_ms(q, store, row_ids, n_docs: int, depth: int, kind: str):
    """Bound of one gathered fused top-k call on this run's data: the query,
    the row ids, and each distinct in-range row read once (a row that
    several queries keep is needed once; padding rows are never read); the
    output written once; 2*T operations for each (query, in-range row)
    pair.  Returns (ms, bound_by, distinct rows)."""
    b, t = q.shape
    valid = (row_ids >= 0) & (row_ids < n_docs)
    pairs = int(valid.sum())
    distinct = int(torch.unique(row_ids[valid]).numel())
    nbytes = (q.numel() * q.element_size() + row_ids.numel() * 4
              + distinct * t * store.element_size() + b * depth * 8)
    return (*_bound(nbytes, 2.0 * pairs * t, kind), distinct)


def compare(name, got, want, exact: bool) -> float:
    """Hold the kernel's (scores, ids) against the plain version's.  Exact
    modes: bit-equal.  Float modes: scores within rtol = atol = 1e-5, and
    ids equal at every rank whose plain score differs from both neighbours
    (the plain list carries one rank more than the kernel's) by more than
    that tolerance.  Returns the largest score difference."""
    gs, gi = (x.cpu() for x in got)
    ws, wi = (x.cpu() for x in want)
    d = gs.shape[1]
    if gs.shape != (ws.shape[0], d) or gi.dtype != torch.int32:
        raise AssertionError(f"{name}: shape/dtype {tuple(gs.shape)} {gi.dtype}")
    fin = torch.isfinite(ws[:, :d])
    if not torch.equal(fin, torch.isfinite(gs)):
        raise AssertionError(f"{name}: -inf slots differ")
    err = float((gs - ws[:, :d])[fin].abs().max()) if bool(fin.any()) else 0.0
    if exact:
        if not (torch.equal(gs, ws[:, :d]) and torch.equal(gi, wi[:, :d])):
            raise AssertionError(f"{name}: not bit-exact (max score err {err})")
        return err
    if not torch.allclose(gs, ws[:, :d], rtol=TOL, atol=TOL):
        raise AssertionError(f"{name}: scores differ by up to {err}")
    tol = TOL + TOL * ws.abs()
    gap = (ws[:, 1:] - ws[:, :-1]).abs()
    big = gap > tol[:, 1:]
    pad = torch.ones_like(big[:, :1])
    lone = torch.cat([pad, big], 1) & torch.cat([big, pad], 1)
    lone = lone[:, :d] | ~fin  # -inf slots must read -1 in both
    if not torch.equal(gi[lone], wi[:, :d][lone]):
        n_bad = int((gi[lone] != wi[:, :d][lone]).sum())
        raise AssertionError(f"{name}: {n_bad} ids differ away from near-ties")
    return err


def build_kernels() -> float:
    from repro_torch.kernels import common

    t0 = time.perf_counter()
    logs = common.build()
    seconds = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "Function properties for" in line:  # names the instance the next lines report
                print(f"  nvcc[{name}] {line.split('Function properties for')[1].strip()[:72]}")
            elif "registers" in line or "spill" in line or "error" in line:
                print(f"  nvcc[{name}] {line.strip()}")
    print(f"kernel build: {seconds:.1f} s for {sorted(logs)} (nvcc, sm_90a)")
    return seconds


def _inputs(kind: str, b: int, n: int, t: int, gen: torch.Generator, dev):
    if kind == "int8":
        q = torch.randint(-50, 50, (b, t), generator=gen, device=dev, dtype=torch.int8)
        d = torch.randint(-50, 50, (n, t), generator=gen, device=dev, dtype=torch.int8)
    elif kind == "ties":  # 0/1 operands: scores tie constantly
        q = torch.randint(0, 2, (b, t), generator=gen, device=dev, dtype=torch.int8)
        d = torch.randint(0, 2, (n, t), generator=gen, device=dev, dtype=torch.int8)
    elif kind == "lsh":
        d = torch.randint(0, 7, (n, t), generator=gen, device=dev, dtype=torch.int32)
        q = d[torch.randint(0, n, (b,), generator=gen, device=dev)].clone()
        q[:, ::5] = -1  # sentinel slots never count
        q, d = q.view(torch.uint32), d.view(torch.uint32)
    else:  # unit-scale floats: scores O(1)
        dtype = torch.bfloat16 if kind == "bf16" else torch.float32
        q = (torch.randn((b, t), generator=gen, device=dev) / t**0.5).to(dtype)
        d = torch.randn((n, t), generator=gen, device=dev).to(dtype)
    return q, d


def check_kernels(dev) -> dict:
    """The fused top-k kernel against its plain version, every score mode."""
    from repro_torch.kernels.fused_topk import ref
    from repro_torch.kernels.fused_topk.kernel import fused_topk

    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for kind in ("bf16", "f32", "int8", "lsh"):
        cases += [
            (kind, 4, 256, 64, 32, None, None),       # aligned
            (kind, 3, 513, 257, 37, None, None),      # unaligned B / N / T
            (kind, 40, 3000, 300, 100, None, None),   # depth 100, 32-query tiles
            (kind, 5, 700, 64, 50, None, 650),        # ragged: rows >= n_docs
            (kind, 6, 900, 100, 60, "shared", None),  # filt (N,)
            (kind, 37, 900, 100, 60, "per-query", 800),  # filt (B, N) + ragged
        ]
    cases += [
        ("ties", 3, 130, 16, 130, None, None),        # depth = N, massive ties
        ("ties", 33, 300, 16, 300, None, None),
        ("ties", 9, 1000, 16, 1000, "shared", None),
        ("f32", 1, 200_000, 300, 100, None, None),    # B = 1: many N-splits
        ("bf16", 300, 20_000, 600, 100, None, None),  # several query tiles
    ]
    worst = {}
    for kind, b, n, t, depth, filt_kind, n_docs in cases:
        q, d = _inputs(kind, b, n, t, gen, dev)
        filt = None
        if filt_kind == "shared":
            filt = torch.rand((n,), generator=gen, device=dev) < 0.3
        elif filt_kind == "per-query":
            filt = torch.rand((b, n), generator=gen, device=dev) < 0.05
        mode = "lsh" if kind == "lsh" else "gemm"
        got = fused_topk(q, d, depth, mode=mode, filt=filt, n_docs=n_docs)
        torch.cuda.synchronize()
        nd = n if n_docs is None else n_docs
        want = ref.fused_topk_ref(q, d, min(depth + 1, nd), mode=mode, filt=filt, n_docs=n_docs)
        name = f"{kind} B={b} N={n} T={t} depth={depth} filt={filt_kind} n_docs={n_docs}"
        err = compare(name, got, want, exact=kind in ("int8", "lsh", "ties"))
        worst[kind] = max(worst.get(kind, 0.0), err)
        print(f"  ok  {name}  max_abs_err={err:.3g}")
    print(f"fused_topk vs plain on the card: {len(cases)} cases, worst {worst}")
    return worst


def gathered_cases():
    """(kind, B, N, R, T, depth, ids, filt, n_docs) for check_gathered."""
    cases = []
    for kind in ("bf16", "f32", "int8", "lsh"):
        cases += [
            (kind, 4, 3000, 1024, 64, 32, "random", False, None),     # aligned rows
            (kind, 3, 2000, 700, 257, 37, "random", False, 1800),     # unaligned T, ids >= n_docs
            (kind, 5, 20_000, 2560, 300, 100, "blocks", False, None),  # 10 kept 256-row blocks
            (kind, 6, 3000, 900, 100, 60, "random", True, None),      # filt (B, R)
        ]
    cases += [
        ("ties", 3, 500, 300, 16, 300, "permutation", False, None),   # depth = R, massive ties
        ("ties", 2, 2048, 1024, 16, 1024, "blocks", True, None),      # ties + filt, depth = R
        ("int8", 4, 5000, 1280, 600, 100, "blocks", False, None),     # 600-byte rows: 8-byte loads
        ("bf16", 1, 400_000, 299_776, 600, 100, "blocks", False, None),  # B = 1: many splits
    ]
    return cases


def _row_ids(how: str, b: int, n: int, r: int, gen, dev):
    """(B, R) int32 row ids: uniform over [0, 1.125 N) with every 17th id
    BIG_ID ("random"), whole 256-row blocks in random order ("blocks"), or
    distinct ids of [0, N + 30) in random order ("permutation")."""
    from repro_torch.kernels.common import BIG_ID

    if how == "random":
        ids = torch.randint(0, n + n // 8, (b, r), generator=gen, device=dev, dtype=torch.int32)
        ids[:, ::17] = BIG_ID
        return ids
    if how == "permutation":
        return torch.stack([torch.randperm(n + 30, generator=gen, device=dev)[:r]
                            for _ in range(b)]).to(torch.int32)
    offsets = torch.arange(BLOCK, device=dev)
    blocks = torch.stack([torch.randperm(-(-n // BLOCK), generator=gen, device=dev)[:r // BLOCK]
                          for _ in range(b)])
    return (blocks[:, :, None] * BLOCK + offsets).reshape(b, -1).to(torch.int32)


def check_gathered(dev) -> dict:
    """The gathered fused top-k kernel (K3) against its plain version."""
    from repro_torch.kernels.fused_topk import ref
    from repro_torch.kernels.fused_topk.kernel import fused_topk_gathered

    gen = torch.Generator(device=dev).manual_seed(1)
    cases = gathered_cases()
    worst = {}
    for kind, b, n, r, t, depth, how, with_filt, n_docs in cases:
        q, store = _inputs(kind, b, n, t, gen, dev)
        ids = _row_ids(how, b, n, r, gen, dev)
        filt = torch.rand((b, r), generator=gen, device=dev) < 0.5 if with_filt else None
        nd = n if n_docs is None else n_docs
        mode = "lsh" if kind == "lsh" else "gemm"
        got = fused_topk_gathered(q, store, ids, depth, nd, mode=mode, filt=filt)
        torch.cuda.synchronize()
        rows = ref.gather_rows(store, ids, nd)
        want = ref.gathered_topk_ref(q, rows, ids, min(depth + 1, r), nd, mode=mode, filt=filt)
        del rows
        name = (f"{kind} B={b} N={n} R={r} T={t} depth={depth} ids={how} filt={with_filt} "
                f"n_docs={n_docs}")
        err = compare(name, got, want, exact=kind in ("int8", "lsh", "ties"))
        worst[kind] = max(worst.get(kind, 0.0), err)
        print(f"  ok  {name}  max_abs_err={err:.3g}")
    print(f"fused_topk_gathered vs plain on the card: {len(cases)} cases, worst {worst}")
    return worst


def _checked(name: str, s, i, b: int, width: int, n: int, finite: bool = True) -> None:
    if s.shape != (b, width) or (finite and not bool(torch.isfinite(s).all())):
        raise AssertionError(f"{name}: bad shape {tuple(s.shape)} or non-finite scores")
    if not bool(((i >= 0) & (i < n)).all()):
        raise AssertionError(f"{name}: ids outside [0, {n})")


def _reset_launches() -> None:
    from repro_torch.kernels.fused_topk.kernel import fused_topk, fused_topk_gathered

    fused_topk.launches = 0
    fused_topk_gathered.launches = 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 stays fp32 in plain versions
    dev = torch.device("cuda", 0)
    card = gpu_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_kernels()
    check_kernels(dev)
    check_gathered(dev)
    from repro_torch.configs import ann_word2vec

    cell = ann_word2vec.ARCH.cell("ann_search")
    kernels = drive(dev, card, cell.get("n_docs"), cell.batch, cell.get("depth"), cell.get("k"),
                    ann_word2vec.ARCH.make_model(cell))
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def drive(dev, card: str, n: int, b: int, depth: int, k: int, config) -> list:
    """Every main path at (n docs, B queries, depth, k) on ``dev``; returns
    the per-kernel JSON entries."""
    from repro_torch.core import blockmax, bruteforce, eval as ev, fakewords, lexical_lsh
    from repro_torch.core import pipeline as pl
    from repro_torch.core.index import AnnIndex
    from repro_torch.core.types import LexicalLshConfig
    from repro_torch.data.embeddings import WORD2VEC_LIKE, make_corpus, make_queries
    from repro_torch.kernels.fused_topk import ops, ref
    from repro_torch.kernels.fused_topk.kernel import fused_topk, fused_topk_gathered

    t0 = time.perf_counter()
    corpus = make_corpus(dataclasses.replace(WORD2VEC_LIKE, n_vectors=n))
    queries, _ = make_queries(corpus, b, seed=1)
    print(f"corpus {corpus.shape} {corpus.dtype} made on the host in "
          f"{time.perf_counter() - t0:.1f} s (seed {WORD2VEC_LIKE.seed})")
    x = torch.from_numpy(corpus).to(dev)
    qx = torch.from_numpy(queries).to(dev)
    del corpus

    # ---- main path 1: classic fake words, dense -------------------------
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = AnnIndex.build(x, config, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    s100, i100 = idx.search(qx, k=depth, depth=depth, rerank=False)
    rr_s, rr_i = idx.search(qx, k=k, depth=depth, rerank=True)
    torch.cuda.synchronize()
    search_launches = fused_topk.launches
    qn = bruteforce.l2_normalize(qx)
    gt_s, gt_i = bruteforce.exact_topk(idx.index.vectors, qn, k, normalized=True)
    torch.cuda.synchronize()
    gt_launches = fused_topk.launches - search_launches
    print(f"main path: build {build_s:.2f} s (first call), index {idx.nbytes() / 1e9:.2f} GB "
          f"on the card; fused_topk launches: search {search_launches}, "
          f"ground truth {gt_launches}")
    if search_launches <= 0 or gt_launches <= 0:
        raise AssertionError("the main path did not run through the fused_topk kernel")
    for name, (s, i, w) in {"match": (s100, i100, depth), "rerank": (rr_s, rr_i, k),
                            "truth": (gt_s, gt_i, k)}.items():
        _checked(name, s, i, b, w, n)
    r10_10 = float(ev.recall_at(gt_i, i100[:, :k]))
    r10_100 = float(ev.recall_at(gt_i, i100))
    r_rr = float(ev.recall_at(gt_i, rr_i))
    print(f"recall: R@(10,10) {r10_10:.4f}  R@(10,100) {r10_100:.4f}  "
          f"reranked R@10 {r_rr:.4f}")
    if abs(r_rr - r10_100) > 0.002:
        raise AssertionError("exact rerank of 100 candidates lost true top-10 ids")

    # The main-path calls against the plain version, 32 queries.
    q_tf = fakewords.encode_queries(qn, config, normalized=True)
    qv = fakewords.classic_query(idx.index, q_tf)
    scored, vectors = idx.index.scored, idx.index.vectors
    err_classic = compare("classic match, 32 queries", (s100[:32], i100[:32]),
                          ref.fused_topk_ref(qv[:32], scored, depth + 1), exact=False)
    err_f32 = compare("f32 ground truth, 32 queries", (gt_s[:32], gt_i[:32]),
                      ref.fused_topk_ref(qn[:32], vectors, k + 1), exact=False)
    print(f"main-path kernel calls vs plain: classic max_abs_err {err_classic:.3g}, "
          f"f32 max_abs_err {err_f32:.3g}")

    # ---- main path 2: blockmax classic ----------------------------------
    n_blocks = -(-n // BLOCK)
    keeps = [int(f * n_blocks) for f in KEEP_FRACTIONS]
    t0 = time.perf_counter()
    bm = blockmax.build_blockmax(idx.index, BLOCK)
    torch.cuda.synchronize()
    print(f"blockmax classic bounds: {n_blocks} blocks of {BLOCK} rows, "
          f"built in {time.perf_counter() - t0:.2f} s (first call)")
    pruned, k3_launches, k3_err = {}, {}, 0.0
    for n_keep in keeps:
        pidx = AnnIndex(config=config, index=idx.index, blockmax_keep=n_keep,
                        blockmax_block_size=BLOCK, bm=bm)
        _reset_launches()
        s, i = pidx.search(qx, k=depth, depth=depth)
        ps, pi = pidx.search(qx, k=k, depth=depth, rerank=True)
        torch.cuda.synchronize()
        k3_launches[n_keep] = fused_topk_gathered.launches
        if fused_topk_gathered.launches <= 0 or fused_topk.launches != 0:
            raise AssertionError(f"blockmax n_keep={n_keep} did not run through K3 alone: "
                                 f"gathered {fused_topk_gathered.launches}, "
                                 f"dense {fused_topk.launches}")
        _checked(f"blockmax n_keep={n_keep}", s, i, b, depth, n)
        _checked(f"blockmax n_keep={n_keep} rerank", ps, pi, b, k, n)
        # The B = 256 call's own K3 launch plan, against the plain version on
        # its first 8 queries (a query's result does not depend on B).
        rows_main = blockmax.kept_rows(bm, q_tf, n_keep)[:8]
        q8v = q_tf[:8].to(torch.bfloat16)
        err_main = compare(
            f"blockmax classic B={b} n_keep={n_keep}, first 8 queries", (s[:8], i[:8]),
            ref.gathered_topk_ref(q8v, ref.gather_rows(scored, rows_main, n), rows_main,
                                  depth + 1, n), exact=False)
        k3_err = max(k3_err, err_main)
        pruned[n_keep] = pidx
        print(f"blockmax classic n_keep={n_keep} ({n_keep * BLOCK} rows a query): "
              f"R@(10,10) {float(ev.recall_at(gt_i, i[:, :k])):.4f}  "
              f"R@(10,100) {float(ev.recall_at(gt_i, i)):.4f}  "
              f"reranked R@10 {float(ev.recall_at(gt_i, pi)):.4f}; "
              f"fused_topk_gathered launches {fused_topk_gathered.launches}; "
              f"K3 vs plain on the first 8 queries max_abs_err {err_main:.3g}")

    # ---- main path 3: lexical LSH (b = 300, h = 1) on K2 ----------------
    lcfg = LexicalLshConfig(buckets=300, hashes=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lidx = AnnIndex.build(x, lcfg, keep_vectors=False, device=dev)
    torch.cuda.synchronize()
    lsh_build_s = time.perf_counter() - t0
    _reset_launches()
    ls, li = lidx.search(qx, k=depth, depth=depth)
    torch.cuda.synchronize()
    lsh_launches = fused_topk.launches
    if lsh_launches <= 0 or fused_topk_gathered.launches != 0:
        raise AssertionError("the LSH search did not run through K1's lsh mode")
    _checked("lsh match", ls, li, b, depth, n)
    sig_q = lexical_lsh.encode(qn, lcfg)
    err_lsh = compare("lsh match, 32 queries", (ls[:32], li[:32]),
                      ref.fused_topk_ref(sig_q[:32], lidx.index.sig, depth + 1, mode="lsh"),
                      exact=True)
    print(f"lexical LSH {lcfg}: build {lsh_build_s:.2f} s (first call), index "
          f"{lidx.nbytes() / 1e9:.2f} GB; R@(10,10) {float(ev.recall_at(gt_i, li[:, :k])):.4f}  "
          f"R@(10,100) {float(ev.recall_at(gt_i, li)):.4f}; fused_topk (lsh) launches "
          f"{lsh_launches}; vs plain on 32 queries max_abs_err {err_lsh:.3g}")

    # ---- every block kept, 8 queries: blockmax equals the dense search ---
    q8 = qx[:8]
    every = AnnIndex(config=config, index=idx.index, blockmax_keep=n_blocks,
                     blockmax_block_size=BLOCK, bm=bm)
    compare("blockmax classic, every block, 8 queries", every.search(q8, k=depth, depth=depth),
            idx.search(q8, k=depth + 1, depth=depth + 1), exact=False)
    bm_dot = blockmax.build_blockmax(idx.index, BLOCK, mode="dot")
    compare("blockmax dot, every block, 8 queries",
            pl.BlockMaxMatcher(n_blocks, bm_dot)(idx.index, q_tf[:8], depth),
            ops.dot_topk(idx.index, q_tf[:8], depth), exact=True)
    every_lsh = AnnIndex(config=lcfg, index=lidx.index, blockmax_keep=n_blocks,
                         blockmax_block_size=BLOCK)
    compare("blockmax lsh, every block, 8 queries", every_lsh.search(q8, k=depth, depth=depth),
            lidx.search(q8, k=depth, depth=depth), exact=True)
    print("blockmax at every block kept equals the dense search: classic (near-tie rule), "
          "dot and lsh (exact)")

    # ---- K3 at the main path's shape (B = 8, 10% of the blocks) ----------
    keep = keeps[0]
    qv8 = q_tf[:8].to(torch.bfloat16)
    rows8 = blockmax.kept_rows(bm, q_tf[:8], keep)
    err_k3 = compare(f"fused_topk_gathered classic, B=8, n_keep={keep}",
                     fused_topk_gathered(qv8, scored, rows8, depth, n),
                     ref.gathered_topk_ref(qv8, ref.gather_rows(scored, rows8, n), rows8,
                                           depth + 1, n),
                     exact=False)
    k3_err = max(k3_err, err_k3)
    print(f"main-path K3 call vs plain: max_abs_err {err_k3:.3g}")

    # ---- times ----------------------------------------------------------
    def rebuild():
        AnnIndex.build(x, config, device=dev)

    t_build = cuda_ms(rebuild, warmup=1)
    t_search = cuda_ms(lambda: idx.search(qx, k=k, depth=depth))
    t_search_rr = cuda_ms(lambda: idx.search(qx, k=k, depth=depth, rerank=True))
    t_search_1 = cuda_ms(lambda: idx.search(qx[:1], k=k, depth=depth))
    t_search_1_rr = cuda_ms(lambda: idx.search(qx[:1], k=k, depth=depth, rerank=True))
    print(f"times (median of {RUNS}, CUDA events) on {card}: build {t_build:.1f} ms; "
          f"search B={b} {t_search:.2f} ms, with rerank {t_search_rr:.2f} ms; "
          f"B=1 {t_search_1:.2f} ms, with rerank {t_search_1_rr:.2f} ms")
    for n_keep, pidx in pruned.items():
        line = []
        for bb in (1, 8):
            plain = cuda_ms(lambda: pidx.search(qx[:bb], k=k, depth=depth))
            rr = cuda_ms(lambda: pidx.search(qx[:bb], k=k, depth=depth, rerank=True))
            stage1 = cuda_ms(lambda: blockmax.kept_rows(bm, q_tf[:bb], n_keep))
            line.append(f"B={bb} {plain:.3f} ms, with rerank {rr:.3f} ms, "
                        f"stage 1 alone {stage1:.3f} ms")
        t_256 = cuda_ms(lambda: pidx.search(qx, k=k, depth=depth), runs=3, warmup=1)
        print(f"blockmax classic n_keep={n_keep} search: {'; '.join(line)}; "
              f"B={b} {t_256:.2f} ms (median of 3)")
    t_lsh = cuda_ms(lambda: lidx.search(qx, k=k, depth=depth))
    t_lsh_1 = cuda_ms(lambda: lidx.search(qx[:1], k=k, depth=depth))
    print(f"lexical LSH search: B={b} {t_lsh:.2f} ms; B=1 {t_lsh_1:.3f} ms")

    kernels = []
    for name, qop, docs, d, kind, launches, err in (
            ("fused_topk", qv, scored, depth, "bf16", search_launches, err_classic),
            ("fused_topk/f32-exact", qn, vectors, k, "f32", gt_launches, err_f32)):
        ms = cuda_ms(lambda: fused_topk(qop, docs, d))
        ms_1 = cuda_ms(lambda: fused_topk(qop[:1], docs, d))
        plain_ms = cuda_ms(lambda: ref.fused_topk_ref(qop, docs, d))
        lib_ms = cuda_ms(lambda: torch.topk(torch.matmul(qop, docs.T), d))
        bound, bound_by = bound_ms(qop, docs, n, d, kind)
        bound_1, _ = bound_ms(qop[:1], docs, n, d, kind)
        print(f"{name} ({kind}, B={qop.shape[0]}, N={n}, T={qop.shape[1]}, depth={d}): "
              f"kernel {ms:.3f} ms, bound {bound:.3f} ms ({bound_by}); "
              f"B=1 kernel {ms_1:.3f} ms, bound {bound_1:.3f} ms; "
              f"plain {plain_ms:.3f} ms; torch.topk(matmul) {lib_ms:.3f} ms")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/fused_topk/csrc/fused_topk.cu",
            "replaces": "src/repro/kernels/fused_topk/kernel.py:288",
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
        })

    # K2: K1's lsh mode at the LSH path's shape.  No single PyTorch call
    # computes collision counts, so it has no library yardstick.
    sig = lidx.index.sig
    ms = cuda_ms(lambda: fused_topk(sig_q, sig, depth, mode="lsh"))
    ms_1 = cuda_ms(lambda: fused_topk(sig_q[:1], sig, depth, mode="lsh"))
    plain_ms = cuda_ms(lambda: ref.fused_topk_ref(sig_q, sig, depth, mode="lsh"),
                       runs=3, warmup=1)
    bound, bound_by = bound_ms(sig_q, sig, n, depth, "int32")
    bound_1, _ = bound_ms(sig_q[:1], sig, n, depth, "int32")
    print(f"fused_topk/lsh (uint32, B={b}, N={n}, S={sig.shape[1]}, depth={depth}): "
          f"kernel {ms:.3f} ms, bound {bound:.3f} ms ({bound_by}); B=1 kernel {ms_1:.3f} ms, "
          f"bound {bound_1:.3f} ms; plain {plain_ms:.3f} ms (median of 3); library: none")
    kernels.append({
        "name": "fused_topk/lsh", "route": "cuda",
        "source": "src/repro_torch/kernels/fused_topk/csrc/fused_topk.cu",
        "replaces": "src/repro/kernels/fused_topk/kernel.py:288",
        "launches": lsh_launches, "max_abs_err": err_lsh, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
    })

    # K3 alone at B = 1 and B = 8, 10% of the blocks, classic.
    k3 = {}
    for bb in (1, 8):
        qb, rb = qv8[:bb], rows8[:bb]
        ms = cuda_ms(lambda: fused_topk_gathered(qb, scored, rb, depth, n))
        plain_ms = cuda_ms(lambda: ref.gathered_topk_ref(qb, ref.gather_rows(scored, rb, n), rb,
                                                         depth, n))
        lib_ms = cuda_ms(lambda: torch.topk(
            torch.einsum("bt,brt->br", qb, scored[rb.long()]), depth))
        bound, bound_by, distinct = gathered_bound_ms(qb, scored, rb, n, depth, "bf16")
        k3[bb] = (ms, plain_ms, lib_ms, bound, bound_by)
        print(f"fused_topk_gathered (bf16, B={bb}, R={rb.shape[1]}, T={qb.shape[1]}, "
              f"depth={depth}, {distinct} distinct rows): kernel {ms:.3f} ms, "
              f"bound {bound:.3f} ms ({bound_by}); "
              f"plain {plain_ms:.3f} ms; torch.topk(einsum(q, store[row_ids])) {lib_ms:.3f} ms")
    ms, plain_ms, lib_ms, bound, bound_by = k3[8]
    kernels.append({
        "name": "fused_topk_gathered", "route": "cuda",
        "source": "src/repro_torch/kernels/fused_topk/csrc/fused_topk.cu",
        "replaces": "src/repro/kernels/fused_topk/kernel.py:433",
        "launches": k3_launches[keep], "max_abs_err": k3_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
    })
    return kernels


if __name__ == "__main__":
    sys.exit(main())
