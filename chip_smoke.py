#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

1. Builds the CUDA kernels from ``src/repro_torch/kernels/*/csrc`` with nvcc
   (sm_90a) and prints the build time and the compiler's register report.
2. Holds the fused top-k kernel against its plain PyTorch version on the
   card in all four score modes (bf16, f32, int8, lsh), with unaligned
   shapes, ragged ``n_docs``, depth = N under massive ties, and ``filt``.
3. Runs the ann-word2vec deployment (2,999,808 x 300, classic fake words,
   B = 256, depth 100, k 10) end to end through ``AnnIndex.build`` /
   ``search`` on the card, with the exact-cosine ground truth, and checks
   recall, the rerank identity and that the kernel carried the path.
4. Times build, search (B = 256 and B = 1), the kernel beside its bound,
   its plain version and a library yardstick, with CUDA events (median of
   10 runs after a warm-up).

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
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
TOL = 1e-5  # rtol = atol for float scores
RUNS = 10


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


def bound_ms(q, docs, n_docs: int, depth: int, kind: str):
    """(least time in ms, "bytes" | "operations") for one fused top-k call:
    each input read once, each output written once; 2*B*N*T operations."""
    b, t = q.shape
    nbytes = (q.numel() * q.element_size() + n_docs * t * docs.element_size()
              + b * depth * 8)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * b * n_docs * t / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
            if "registers" in line or "spill" in line or "error" in line:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.configs import ann_word2vec
    from repro_torch.core import bruteforce, eval as ev, fakewords
    from repro_torch.core.index import AnnIndex
    from repro_torch.data.embeddings import WORD2VEC_LIKE, make_corpus, make_queries
    from repro_torch.kernels.fused_topk import ref
    from repro_torch.kernels.fused_topk.kernel import fused_topk

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 stays fp32 in plain versions
    dev = torch.device("cuda", 0)
    card = gpu_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_kernels()
    check_kernels(dev)

    # ---- the main path: ann-word2vec, full size -------------------------
    arch = ann_word2vec.ARCH
    cell = arch.cell("ann_search")
    n, b, depth, k = cell.get("n_docs"), cell.batch, cell.get("depth"), cell.get("k")
    config = arch.make_model(cell)
    t0 = time.perf_counter()
    corpus = make_corpus(dataclasses.replace(WORD2VEC_LIKE, n_vectors=n))
    queries, _ = make_queries(corpus, b, seed=1)
    print(f"corpus {corpus.shape} {corpus.dtype} made on the host in "
          f"{time.perf_counter() - t0:.1f} s (seed {WORD2VEC_LIKE.seed})")
    x = torch.from_numpy(corpus).to(dev)
    qx = torch.from_numpy(queries).to(dev)
    del corpus

    fused_topk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = AnnIndex.build(x, config)
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
        if s.shape != (b, w) or not bool(torch.isfinite(s).all()):
            raise AssertionError(f"{name}: bad shape {tuple(s.shape)} or non-finite scores")
        if not bool(((i >= 0) & (i < n)).all()):
            raise AssertionError(f"{name}: ids outside [0, {n})")
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

    # ---- times ----------------------------------------------------------
    def rebuild():
        AnnIndex.build(x, config)

    t_build = cuda_ms(rebuild, warmup=1)
    t_search = cuda_ms(lambda: idx.search(qx, k=k, depth=depth))
    t_search_rr = cuda_ms(lambda: idx.search(qx, k=k, depth=depth, rerank=True))
    t_search_1 = cuda_ms(lambda: idx.search(qx[:1], k=k, depth=depth))
    t_search_1_rr = cuda_ms(lambda: idx.search(qx[:1], k=k, depth=depth, rerank=True))
    print(f"times (median of {RUNS}, CUDA events) on {card}: build {t_build:.1f} ms; "
          f"search B={b} {t_search:.2f} ms, with rerank {t_search_rr:.2f} ms; "
          f"B=1 {t_search_1:.2f} ms, with rerank {t_search_1_rr:.2f} ms")

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
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
