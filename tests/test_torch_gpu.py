"""The port on a CUDA card: the fused top-k kernels (K1/K2, the gathered K3,
and the quantized K4/K5) against their plain versions, and the searches on
the card (dense, blockmax, lexical LSH, the quantized read path, the k-d
tree's scan and tree) against the port's CPU route, and save / load there;
K9's backward and a training step of the LM on the card; GraphSAGE's three
paths and the four recsys towers against the CPU route; ``f32_matmul``
under TF32 settings, ``compressed_psum`` and GPipe on 4 x cuda:0.
Every test carries the ``gpu`` marker and skips without a card; this file
imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch
from torch_parity import (BWD_CUDA_DTYPE_CASES, BWD_CUDA_F32_ROW_CASES,
                          assert_attention_grads_close, assert_rows_close, assert_topk_match,
                          cuda_device)

from repro_torch.core import builder, bruteforce
from repro_torch.core import eval as ev
from repro_torch.core.index import AnnIndex
from repro_torch.core.types import (
    BruteForceConfig,
    FakeWordsConfig,
    GraphConfig,
    KdTreeConfig,
    LexicalLshConfig,
)
from repro_torch.kernels.fused_topk import ref
from repro_torch.kernels.common import round_up
from repro_torch.kernels.fused_topk.kernel import (
    fused_topk,
    fused_topk_gathered,
    fused_topk_gathered_quantized,
    fused_topk_quantized,
    gathered_plan,
    gathered_quantized_plan,
    plan,
    quantized_plan,
)


def _operands(kind: str, b: int, n: int, t: int, dev: torch.device):
    g = torch.Generator(device=dev).manual_seed(41)
    if kind in ("int8", "ties"):
        lo, hi = (-50, 50) if kind == "int8" else (0, 2)
        return tuple(torch.randint(lo, hi, shape, generator=g, device=dev, dtype=torch.int8)
                     for shape in ((b, t), (n, t)))
    if kind == "lsh":
        d = torch.randint(0, 7, (n, t), generator=g, device=dev, dtype=torch.int32)
        q = d[:b].clone()
        q[:, ::5] = -1  # sentinel slots never count
        return q.view(torch.uint32), d.view(torch.uint32)
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    return ((torch.randn((b, t), generator=g, device=dev) / t**0.5).to(dtype),
            torch.randn((n, t), generator=g, device=dev).to(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bf16", "f32", "int8", "lsh", "ties"])
@pytest.mark.parametrize("kernel", ["fused_topk", "fused_topk_gathered"])
def test_cuda_kernel_matches_plain_version(kernel, kind):
    dev = cuda_device()
    b, n, t, depth = (9, 1000, 16, 1000) if kind == "ties" else (37, 3000, 257, 100)
    q, d = _operands(kind, b, n, t, dev)
    mode = "lsh" if kind == "lsh" else "gemm"
    g = torch.Generator(device=dev).manual_seed(0)
    exact = kind in ("int8", "lsh", "ties")
    if kernel == "fused_topk":
        filt = torch.rand((b, n), generator=g, device=dev) < 0.5
        before = fused_topk.launches
        got = fused_topk(q, d, depth, mode=mode, filt=filt)
        torch.cuda.synchronize()
        assert fused_topk.launches == before + 1
        want = ref.fused_topk_ref(q, d, min(depth + 1, n), mode=mode, filt=filt)
    else:  # ids in random order, some >= n_docs, and a (B, R) filt
        r, n_docs = n, n - 100
        ids = torch.stack([torch.randperm(n, generator=g, device=dev) for _ in range(b)])
        ids = ids.to(torch.int32)
        filt = torch.rand((b, r), generator=g, device=dev) < 0.5
        before = fused_topk_gathered.launches
        got = fused_topk_gathered(q, d, ids, min(depth, n_docs), n_docs, mode=mode, filt=filt)
        torch.cuda.synchronize()
        assert fused_topk_gathered.launches == before + 1
        rows = ref.gather_rows(d, ids, n_docs)
        want = ref.gathered_topk_ref(q, rows, ids, min(depth + 1, n_docs), n_docs, mode=mode,
                                     filt=filt)
    assert_topk_match([x.cpu() for x in got], [x.cpu() for x in want], exact=exact)


def _float_operands(kind: str, b: int, n: int, t: int, dev: torch.device,
                   dtype: torch.dtype = torch.bfloat16):
    """bf16 or f32 operands whose scores are small integers, exact in f32:
    0/1 values ("ties"), or scores 4 * id + (0..3) that rise ("rising") or
    fall ("falling") with the doc id, so that every tile (rising) or only
    the first (falling) sends candidates to the running lists.  Every value
    is an integer below 2^11, its own high tf32 part."""
    g = torch.Generator(device=dev).manual_seed(47)
    if kind == "ties":
        return tuple(torch.randint(0, 2, shape, generator=g, device=dev).to(dtype)
                     for shape in ((b, t), (n, t)))
    ids = torch.arange(n, device=dev)
    d = torch.randint(-3, 4, (n, t), generator=g, device=dev)
    d[:, 0], d[:, 1] = ids // 256, ids % 256
    d[:, 2] = torch.randint(0, 4, (n,), generator=g, device=dev)
    q = torch.zeros((b, t), device=dev)
    q[:, 0], q[:, 1] = 1024, 4
    q[:, 2] = torch.randint(0, 2, (b,), generator=g, device=dev)
    return (q if kind == "rising" else -q).to(dtype), d.to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,b,n,t,depth", [
    ("ties", 9, 1000, 16, 1000),      # depth = N, ties everywhere
    ("ties", 33, 300, 16, 300),       # 64-query tile, ragged B
    ("rising", 65, 20_000, 37, 100),  # every tile flushes; two query tiles, ragged T
    ("falling", 65, 20_000, 37, 100),
    ("rising", 1, 20_000, 600, 100),  # 8-query tiles
    ("wide", 1, 5000, 64, 3072),      # the widest list: one stage, merge by insert
])
def test_cuda_bf16_topk_ties_order_and_wide_lists(kind, b, n, t, depth):
    """The tensor-core bf16 pass 1 where its running top-k must be exact:
    integer scores make ids bit-equal to the plain version's."""
    dev = cuda_device()
    if kind == "wide":
        q, d = _operands("bf16", b, n, t, dev)
    else:
        q, d = _float_operands(kind, b, n, t, dev)
    got = fused_topk(q, d, depth)
    torch.cuda.synchronize()
    want = ref.fused_topk_ref(q, d, min(depth + 1, n))
    assert_topk_match([x.cpu() for x in got], [x.cpu() for x in want], exact=kind != "wide")


@pytest.mark.gpu
@pytest.mark.parametrize("kind,b,n,t,depth", [
    ("ties", 9, 1000, 16, 1000),      # depth = N, ties everywhere
    ("ties", 65, 600, 300, 600),      # depth = N at the cosine's T, 64-query tiles
    ("rising", 65, 20_000, 300, 100),  # every tile flushes; rows through the ring
    ("falling", 65, 20_000, 37, 100),  # rows through registers
    ("rising", 1, 20_000, 300, 100),  # 8-query tiles
    ("wide", 1, 5000, 64, 3072),      # the widest list: one stage, merge by insert
    ("unit", 256, 20_000, 300, 10),   # the exact cosine's operands and depth
    ("unit", 8, 20_000, 300, 10),
    ("unit", 1, 20_000, 300, 10),
])
def test_cuda_f32_topk_ties_order_and_wide_lists(kind, b, n, t, depth):
    """The split-TF32 f32 pass 1 (K1 f32): integer values are their own high
    tf32 part, so integer scores and ids are bit-equal to the plain
    version's; random and unit rows are held to the near-tie rule."""
    dev = cuda_device()
    if kind == "unit":
        g = torch.Generator(device=dev).manual_seed(67)
        q, d = (torch.nn.functional.normalize(torch.randn(shape, generator=g, device=dev), dim=1)
                for shape in ((b, t), (n, t)))
    elif kind == "wide":
        q, d = _operands("f32", b, n, t, dev)
    else:
        q, d = _float_operands(kind, b, n, t, dev, torch.float32)
    got = fused_topk(q, d, depth)
    torch.cuda.synchronize()
    want = ref.fused_topk_ref(q, d, min(depth + 1, n))
    assert_topk_match([x.cpu() for x in got], [x.cpu() for x in want],
                      exact=kind not in ("wide", "unit"))


def _int8_operands(kind: str, b: int, n: int, t: int, dev: torch.device):
    """int8 operands with exact integer scores: 0/1 values ("ties"), -128
    and 127 only ("extremes"), every int8 value ("full"), or scores
    4 id - 51,200 + (0..3) that rise ("rising") or fall ("falling") with
    the doc id (T >= 7, N <= 29,184)."""
    g = torch.Generator(device=dev).manual_seed(53)
    if kind == "ties":
        return tuple(torch.randint(0, 2, shape, generator=g, device=dev, dtype=torch.int8)
                     for shape in ((b, t), (n, t)))
    if kind == "extremes":
        return tuple(torch.where(torch.rand(shape, generator=g, device=dev) < 0.5, -128, 127)
                     .to(torch.int8) for shape in ((b, t), (n, t)))
    if kind == "full":
        return tuple(torch.randint(-128, 128, shape, generator=g, device=dev, dtype=torch.int8)
                     for shape in ((b, t), (n, t)))
    ids = torch.arange(n, device=dev)
    d = torch.randint(-3, 4, (n, t), generator=g, device=dev)
    d[:, :5] = (ids // 128 - 100)[:, None]  # against 127 four times and 4: 512 (id // 128)
    d[:, 5] = ids % 128                     # against 4
    d[:, 6] = torch.randint(0, 4, (n,), generator=g, device=dev)
    q = torch.zeros((b, t), dtype=torch.long, device=dev)
    q[:, :4], q[:, 4], q[:, 5] = 127, 4, 4
    q[:, 6] = torch.randint(0, 2, (b,), generator=g, device=dev)
    return (q if kind == "rising" else -q).to(torch.int8), d.to(torch.int8)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,b,n,t,depth,filt", [
    ("ties", 9, 1000, 16, 1000, None),          # depth = N, ties everywhere (16-byte rows)
    ("ties", 65, 600, 600, 600, None),          # depth = N at 600-byte rows (8-byte copies)
    ("rising", 65, 20_000, 600, 100, None),     # every tile flushes; two query tiles
    ("falling", 65, 20_000, 600, 100, "per-query"),  # only the first tiles flush
    ("rising", 1, 20_000, 600, 100, None),      # 8-query tiles
    ("falling", 5, 20_000, 37, 100, None),      # rows through registers
    ("rising", 65, 20_000, 37, 100, "per-query"),
    ("full", 65, 20_000, 256, 100, None),       # 16-byte rows
    ("full", 1, 20_000, 256, 3072, None),       # depth 3,072 at B = 1
    ("extremes", 65, 5000, 600, 3072, None),    # and at B = 65
    ("extremes", 3, 20_000, 600, 100, "per-query"),
])
def test_cuda_int8_topk_ties_order_and_wide_lists(kind, b, n, t, depth, filt):
    """The tensor-core int8 pass 1 (K1 dot): its sums are exact int32, so
    scores and ids are bit-equal to the plain version's."""
    dev = cuda_device()
    q, d = _int8_operands(kind, b, n, t, dev)
    g = torch.Generator(device=dev).manual_seed(59)
    keep = torch.rand((b, n), generator=g, device=dev) < 0.3 if filt else None
    got = fused_topk(q, d, depth, filt=keep)
    torch.cuda.synchronize()
    want = ref.fused_topk_ref(q, d, min(depth + 1, n), filt=keep)
    assert_topk_match([x.cpu() for x in got], [x.cpu() for x in want], exact=True)


@pytest.mark.gpu
def test_launch_plan_fills_the_card_at_both_batch_sizes():
    cuda_device()
    n = 2_999_808
    # f32, bf16 and int8 on tensor cores (the mma plan: 8-query tiles at
    # B = 1), lsh on CUDA cores (K2's plan: a 1-query tile at B = 1)
    for code, bq_1 in ((0, 8), (1, 8), (2, 8), (3, 1)):
        for b, bq_want in ((256, 64), (1, bq_1)):
            bq, k, splits, per, tile = plan(code, b, n, 100, sm_count=132)
            n_tiles = -(-n // tile)
            assert (bq, k) == (bq_want, 128)
            assert -(-b // bq) * splits >= 132
            assert (splits - 1) * per < n_tiles <= splits * per  # no empty split
    for code in (0, 1, 2, 3):
        assert plan(code, 256, 5000, 1000, 132)[0] == 8  # wide lists: 8-query blocks
        assert plan(code, 1, 5000, 3072, 132)[1] == 3072
    # K2: at B <= 8 the query tile of 1, 2, 4 or 8 rows that holds B, so no
    # padded row runs a compare; 128-doc tiles at 64 queries, 256 below; at
    # B = 1 two blocks a SM; lists up to pass 2's limit (two lists of depth)
    for b, bq_want in ((1, 1), (2, 2), (3, 4), (4, 4), (5, 8), (8, 8), (9, 64), (40, 64)):
        bq, _, _, _, tile = plan(3, b, n, 100, sm_count=132)
        assert (bq, tile) == (bq_want, 128 if bq == 64 else 256)
    assert plan(3, 1, n, 100, 132)[2:4] == (261, 45)  # two blocks a SM: 264 wanted
    assert plan(3, 8, n, 3072, 132)[:2] == (4, 3072)  # lists of 3,072 at 8 queries do not fit
    assert plan(3, 1, 10_000, 7255, 132)[1] == 7264
    with pytest.raises(ValueError, match="shared memory"):
        plan(3, 1, 10_000, 7256, 132)
    # f32, bf16 and int8 at 8-query tiles drop to one stage of 128 docs for wide lists
    for code in (0, 1, 2):
        assert plan(code, 1, 5000, 3136, 132)[1:] == (3136, 40, 1, 128)
        with pytest.raises(ValueError, match="shared memory"):
            plan(code, 1, 5000, 3137, 132)
    # the gathered kernel: B x splits covers the SMs; >= 256 rows a split
    r = 1171 * 256
    for b in (1, 8, 256):
        k, splits, per = gathered_plan(1, b, r, 600, 100, sm_count=132)
        assert k == 128 and per % 32 == 0 and (splits - 1) * per < r <= splits * per
        assert b * splits >= 132 and per >= 256
    # one list a block: depth is bounded by pass 2's two lists of depth
    assert gathered_plan(1, 1, 10_000, 600, 7255, sm_count=132)[0] == 7264
    with pytest.raises(ValueError, match="shared memory"):
        gathered_plan(1, 1, 10_000, 600, 7256, sm_count=132)


def _lsh_operands(kind: str, b: int, n: int, s: int, dev: torch.device):
    """uint32 signatures: "ties" copies 4 doc rows (sentinels in docs too)
    and takes the queries from the docs, so the depth-th count is held by
    docs of every split; "empty" all-sentinel queries (every count 0)."""
    g = torch.Generator(device=dev).manual_seed(67)
    if kind == "ties":
        base = torch.randint(0, 7, (4, s), generator=g, device=dev, dtype=torch.int32)
        base[:, ::5] = -1
        d = base[torch.randint(0, 4, (n,), generator=g, device=dev)]
        q = d[torch.randint(0, n, (b,), generator=g, device=dev)].clone()
    else:
        d = torch.randint(-1, 7, (n, s), generator=g, device=dev, dtype=torch.int32)
        q = torch.full((b, s), -1, device=dev, dtype=torch.int32)
    return q.view(torch.uint32), d.view(torch.uint32)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,b,n,s,depth,filt,n_docs", [
    ("ties", 1, 200_000, 300, 100, None, None),     # 261 splits, the depth-th count in each
    ("ties", 8, 200_000, 300, 100, None, None),
    ("ties", 256, 100_000, 300, 100, None, None),   # 64-query tiles
    ("ties", 3, 20_000, 37, 1000, "per-query", None),  # 4-byte copies, wide lists
    ("ties", 40, 20_000, 1500, 100, "shared", 19_500),  # b = 50, h = 30's width
    ("empty", 1, 20_000, 300, 100, None, None),     # every count 0: ids 0..depth-1
    ("empty", 5, 20_000, 300, 100, "per-query", 19_000),
    ("empty", 40, 20_000, 300, 3072, None, None),
])
def test_cuda_lsh_ties_empty_and_filt(kind, b, n, s, depth, filt, n_docs):
    """K2 where its register threshold, buffer and pass 2 must be exact:
    collision counts, so scores and ids are bit-equal to the plain
    version's at every tie, with filt and n_docs."""
    dev = cuda_device()
    q, d = _lsh_operands(kind, b, n, s, dev)
    g = torch.Generator(device=dev).manual_seed(71)
    keep = None
    if filt == "shared":
        keep = torch.rand((n,), generator=g, device=dev) < 0.3
    elif filt == "per-query":
        keep = torch.rand((b, n), generator=g, device=dev) < 0.1
    before = fused_topk.launches
    got = fused_topk(q, d, depth, mode="lsh", filt=keep, n_docs=n_docs)
    torch.cuda.synchronize()
    assert fused_topk.launches == before + 1
    want = ref.fused_topk_ref(q, d, min(depth + 1, n_docs or n), mode="lsh", filt=keep,
                              n_docs=n_docs)
    assert_topk_match([x.cpu() for x in got], [x.cpu() for x in want], exact=True)


@pytest.mark.gpu
def test_gathered_plan_walks_long_row_ranges_at_small_batch():
    """K3's plan: B x splits is the blocks the SMs hold at once (two each),
    so at B = 1 and 8 each block walks a long row range and pass 2 merges
    no more lists than that; from B = 264 on, one split a query."""
    cuda_device()
    r = 1171 * 256
    for b, want in ((1, 261), (8, 33), (256, 2), (264, 1), (1000, 1)):
        k, splits, per = gathered_plan(1, b, r, 600, 100, sm_count=132)
        assert (k, splits) == (128, want)
        assert b * splits <= 2 * 132 or splits <= 2
        assert per % 32 == 0 and (splits - 1) * per < r <= splits * per
    # no split under one round of 256 rows, however few the rows
    assert gathered_plan(1, 1, 1000, 600, 100, sm_count=132)[1:] == (4, 256)


def _block_ids(how: str, b: int, n: int, r: int, q, d, dev, scores=None):
    """(B, R) int32 ids of whole 256-row blocks: in random order ("blocks"),
    best block first by the plain scores ("bound"; ``scores`` (B, N) where
    given, else those of q and d), or "blocks" with every third block
    padding ids, BIG_ID or >= n ("padded")."""
    g = torch.Generator(device=dev).manual_seed(61)
    n_blocks = n // 256
    if how == "bound":
        scores = ref.scores_ref(q, d) if scores is None else scores
        best = scores.reshape(b, n_blocks, 256).amax(-1)
        blocks = torch.sort(best, dim=1, descending=True, stable=True)[1][:, :r // 256]
    else:
        blocks = torch.stack([torch.randperm(n_blocks, generator=g, device=dev)[:r // 256]
                              for _ in range(b)])
    ids = (blocks[:, :, None] * 256 + torch.arange(256, device=dev)).to(torch.int32)
    if how == "padded":
        ids[:, ::3] = 2**30
        ids[:, 1::6] += n
    return ids.reshape(b, -1)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,b,n,r,t,depth,how", [
    ("ties", 1, 204_800, 102_400, 16, 100, "blocks"),   # every rank tied, many splits
    ("ties", 1, 204_800, 102_400, 16, 100, "bound"),
    ("ties", 3, 20_480, 7_680, 16, 100, "padded"),      # whole splits of padding ids
    ("ties", 2, 2_048, 768, 16, 768, "blocks"),         # depth = R
    ("ties", 2, 20_480, 7_680, 16, 2000, "padded"),     # wide lists: inserts, chunked pass 2
    ("int8", 8, 51_200, 25_600, 600, 100, "bound"),     # 600-byte rows in bound order
])
def test_cuda_gathered_ties_padding_and_bound_order(kind, b, n, r, t, depth, how):
    """K3 where its block list and pass 2 must be exact: integer scores, so
    ids are bit-equal to the plain version's at every tie."""
    dev = cuda_device()
    q, d = _operands(kind, b, n, t, dev)
    ids = _block_ids(how, b, n, r, q, d, dev)
    got = fused_topk_gathered(q, d, ids, depth, n)
    torch.cuda.synchronize()
    want = ref.gathered_topk_ref(q, ref.gather_rows(d, ids, n), ids, min(depth + 1, r), n)
    assert_topk_match([x.cpu() for x in got], [x.cpu() for x in want], exact=True)


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["classic", "dot", "bruteforce", "lsh", "blockmax-classic",
                                    "blockmax-dot", "blockmax-lsh"])
def test_cuda_search_matches_cpu_port(method):
    cuda_device()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2000, 64)).astype(np.float32)
    q = x[:24] + 0.05 * rng.normal(size=(24, 64)).astype(np.float32)
    kind = method.split("-")[-1]
    cfg = {"bruteforce": BruteForceConfig(), "lsh": LexicalLshConfig(buckets=64, hashes=2)}.get(
        kind) or FakeWordsConfig(scoring=kind)
    keep = 3 if method.startswith("blockmax") else None
    cpu = AnnIndex.build(x, cfg, blockmax_keep=keep, blockmax_block_size=128, device="cpu")
    gpu = AnnIndex.build(x, cfg, blockmax_keep=keep, blockmax_block_size=128)
    assert gpu.device.type == "cuda"
    for rerank in (False, True):
        want = cpu.search(q, k=10, depth=100, rerank=rerank)
        got = gpu.search(q, k=10, depth=100, rerank=rerank)
        assert float(ev.overlap(want[1], got[1].cpu())) >= 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("qdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bits,group", [(8, 0), (4, 32), (4, 64)])
@pytest.mark.parametrize("kernel", ["fused_topk_quantized", "fused_topk_gathered_quantized"])
def test_cuda_quantized_kernel_matches_plain_version(kernel, bits, group, qdtype):
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(43)
    b, n, t, depth = 37, 3000, 600, 100
    pq = builder.quantize_postings(torch.randn((n, t), generator=g, device=dev), bits, group or 32)
    q = (torch.randn((b, t), generator=g, device=dev) / t**0.5).to(qdtype)
    if kernel == "fused_topk_quantized":
        filt = torch.rand((b, n), generator=g, device=dev) < 0.5
        before = fused_topk_quantized.launches
        got = fused_topk_quantized(q, pq.q, pq.scale, depth, bits, group, filt=filt,
                                   n_docs=n - 100)
        torch.cuda.synchronize()
        assert fused_topk_quantized.launches == before + 1
        want = ref.quantized_topk_ref(q, pq.q, pq.scale, depth + 1, bits, group, filt, n - 100)
    else:  # ids in random order, some >= n_docs, and a (B, R) filt
        n_docs = n - 100
        ids = torch.stack([torch.randperm(n, generator=g, device=dev) for _ in range(b)])
        ids = ids.to(torch.int32)
        filt = torch.rand((b, n), generator=g, device=dev) < 0.5
        before = fused_topk_gathered_quantized.launches
        got = fused_topk_gathered_quantized(q, pq.q, pq.scale, ids, depth, n_docs, bits, group,
                                            filt=filt)
        torch.cuda.synchronize()
        assert fused_topk_gathered_quantized.launches == before + 1
        want = ref.quantized_gathered_topk_ref(q, pq.q, pq.scale, ids, depth + 1, n_docs, bits,
                                               group, filt)
    assert_topk_match([x.cpu() for x in got], [x.cpu() for x in want], exact=False)


def _packed_operands(kind: str, bits: int, group: int, b: int, n: int, t: int,
                     dev: torch.device, qdtype: torch.dtype = torch.bfloat16):
    """(query of ``qdtype``, packed store, scales) with unit scales and small
    integer scores, exact in f32 (an integer f32 query is its own high tf32
    part): 0/1 values ("ties"), or scores 4 * id + (0..3)
    minus a constant that rise ("rising") or fall ("falling") with the doc
    id, from int8 columns id // 128 - 100 and id % 128 or from the base-16
    digits of the id as int4 values."""
    g = torch.Generator(device=dev).manual_seed(53)
    tg = round_up(t, group) if bits == 4 else t
    if kind == "ties":
        q = torch.randint(0, 2, (b, t), generator=g, device=dev)
        vals = torch.randint(0, 2, (n, tg), generator=g, device=dev)
    else:
        ids = torch.arange(n, device=dev)
        q = torch.zeros((b, t), device=dev)
        vals = torch.randint(-3, 4, (n, tg), generator=g, device=dev)
        if bits == 8:
            vals[:, 0], vals[:, 1] = ids // 128 - 100, ids % 128
            q[:, 0], q[:, 1] = 512, 4
        else:
            for c, w in enumerate((4096, 256, 16, 1)):
                vals[:, c] = ids // w % 16 - 8
                q[:, c] = 4 * w
        vals[:, 4] = torch.randint(0, 4, (n,), generator=g, device=dev)
        q[:, 4] = torch.randint(0, 2, (b,), generator=g, device=dev)
        q = q if kind == "rising" else -q
    if bits == 8:
        return q.to(qdtype), vals.to(torch.int8), torch.ones((n, 1), device=dev)
    nib = vals + 8
    nib[:, t:] = 8  # pad columns hold the value 0, as the builder writes them
    packed = (nib[:, 0::2] | (nib[:, 1::2] << 4)).to(torch.uint8)
    return q.to(qdtype), packed, torch.ones((n, tg // group), device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,bits,group,b,n,t,depth", [
    ("ties", 8, 0, 9, 1000, 16, 1000),        # depth = N, ties everywhere
    ("ties", 4, 32, 33, 300, 64, 300),        # 64-query tile, ragged B
    ("rising", 8, 0, 65, 20_000, 37, 100),    # every tile flushes; rows not 8-byte aligned
    ("falling", 8, 0, 65, 20_000, 600, 100),  # only the first tiles flush
    ("falling", 4, 32, 65, 20_000, 600, 100),  # T = 600: the last chunk past the last group
    ("rising", 4, 64, 1, 20_000, 600, 100),   # 8-query tiles
    ("wide", 8, 0, 1, 5000, 64, 3072),        # the widest list: one stage, merge by insert
    ("wide", 4, 32, 65, 5000, 600, 3072),
])
def test_cuda_quantized_bf16_topk_ties_order_and_wide_lists(kind, bits, group, b, n, t, depth):
    """K4's tensor-core pass 1 (a bf16 query) where its running top-k must
    be exact: integer scores make ids bit-equal to the plain version's."""
    dev = cuda_device()
    if kind == "wide":
        g = torch.Generator(device=dev).manual_seed(59)
        pq = builder.quantize_postings(torch.randn((n, t), generator=g, device=dev), bits, group)
        q = (torch.randn((b, t), generator=g, device=dev) / t**0.5).to(torch.bfloat16)
        docs, scale = pq.q, pq.scale
    else:
        q, docs, scale = _packed_operands(kind, bits, group, b, n, t, dev)
    before = fused_topk_quantized.launches
    got = fused_topk_quantized(q, docs, scale, depth, bits, group)
    torch.cuda.synchronize()
    assert fused_topk_quantized.launches == before + 1
    want = ref.quantized_topk_ref(q, docs, scale, min(depth + 1, n), bits, group)
    assert_topk_match([x.cpu() for x in got], [x.cpu() for x in want], exact=kind != "wide")


@pytest.mark.gpu
@pytest.mark.parametrize("kind,b,n,t,depth", [
    ("ties", 9, 1000, 16, 1000),        # depth = N, ties everywhere
    ("ties", 33, 300, 300, 300),        # 64-query tile, ragged B, 4-byte rows
    ("rising", 65, 20_000, 37, 100),    # every tile flushes; 1-byte rows: registers
    ("falling", 65, 20_000, 300, 100),  # only the first tiles flush; the 4-byte ring
    ("falling", 8, 20_000, 300, 100),   # 8-query tiles
    ("rising", 1, 20_000, 600, 100),    # 8-byte rows
    ("wide", 1, 5000, 64, 3072),        # the widest list: one stage, merge by insert
    ("wide", 65, 5000, 300, 3072),
    ("wide", 1, 5000, 37, 2200),        # too wide for 256-doc tiles with registers
    ("wide", 65, 5000, 37, 2200),
])
@pytest.mark.parametrize("bits,group", [(8, 0), (4, 32), (4, 64)])
def test_cuda_quantized_tf32_topk_ties_order_and_wide_lists(kind, b, n, t, depth, bits, group):
    """K4's split-TF32 pass 1 (an f32 query over int8 rows, or over int4 rows
    at groups 32 and 64) where its running top-k must be exact: integer
    scores make ids bit-equal to the plain version's."""
    dev = cuda_device()
    if kind == "wide":
        g = torch.Generator(device=dev).manual_seed(61)
        pq = builder.quantize_postings(torch.randn((n, t), generator=g, device=dev), bits,
                                       group or 32)
        q = torch.randn((b, t), generator=g, device=dev) / t**0.5
        docs, scale = pq.q, pq.scale
    else:
        q, docs, scale = _packed_operands(kind, bits, group, b, n, t, dev, torch.float32)
    before = fused_topk_quantized.launches
    got = fused_topk_quantized(q, docs, scale, depth, bits, group)
    torch.cuda.synchronize()
    assert fused_topk_quantized.launches == before + 1
    want = ref.quantized_topk_ref(q, docs, scale, min(depth + 1, n), bits, group)
    assert_topk_match([x.cpu() for x in got], [x.cpu() for x in want], exact=kind != "wide")


@pytest.mark.gpu
def test_gathered_quantized_plan_walks_long_row_ranges_at_small_batch():
    """K5's plan is K3's (one list a block): B x splits is the blocks the
    SMs hold at once (two each), so at B = 1 and 8 each block walks a long
    row range; from B = 264 on, one split a query.  One list a block takes
    depth up to pass 2's limit, 7,255, over int8 and int4 rows alike."""
    cuda_device()
    r = 1171 * 256
    for bits in (8, 4):
        for b, want in ((1, 261), (8, 33), (256, 2), (264, 1)):
            k, splits, per = gathered_quantized_plan(bits, b, r, 600, 100, sm_count=132)
            assert (k, splits) == (128, want)
            assert per % 32 == 0 and (splits - 1) * per < r <= splits * per
        assert gathered_quantized_plan(bits, 1, 10_000, 600, 7255, sm_count=132)[0] == 7264
        with pytest.raises(ValueError, match="shared memory"):
            gathered_quantized_plan(bits, 1, 10_000, 600, 7256, sm_count=132)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,bits,group,qdtype,b,n,r,t,depth,how", [
    ("ties", 4, 32, torch.bfloat16, 1, 204_800, 102_400, 64, 100, "blocks"),  # many splits
    ("ties", 8, 0, torch.float32, 1, 204_800, 102_400, 16, 100, "bound"),
    ("ties", 4, 32, torch.float32, 3, 20_480, 7_680, 64, 100, "padded"),  # splits of padding
    ("ties", 8, 0, torch.bfloat16, 2, 2_048, 768, 37, 768, "blocks"),     # depth = R; 1-byte rows
    ("ties", 8, 0, torch.bfloat16, 2, 20_480, 7_680, 100, 2000, "padded"),  # wide lists; 4-byte
    ("ties", 4, 32, torch.bfloat16, 1, 20_480, 10_240, 64, 4096, "blocks"),  # past per-warp lists
    ("rising", 4, 32, torch.bfloat16, 8, 51_200, 25_600, 600, 100, "bound"),  # int4 T = 600
    ("falling", 8, 0, torch.bfloat16, 8, 25_600, 12_800, 600, 100, "bound"),  # 8-byte rows
])
def test_cuda_gathered_quantized_ties_padding_and_bound_order(kind, bits, group, qdtype, b, n,
                                                              r, t, depth, how):
    """K5 where its block list and pass 2 must be exact: integer-valued
    stores with unit scales, so ids are bit-equal to the plain version's at
    every tie, with row ids in random block order, in bound order (best
    block first), with whole splits of padding ids, at depth = R and past
    the per-warp lists' limit of the earlier design."""
    dev = cuda_device()
    q, docs, scale = _packed_operands(kind, bits, group, b, n, t, dev, qdtype)
    scores = ref.quantized_scores_ref(q, docs, scale, bits, group) if how == "bound" else None
    ids = _block_ids(how, b, n, r, q, docs, dev, scores)
    got = fused_topk_gathered_quantized(q, docs, scale, ids, depth, n, bits, group)
    torch.cuda.synchronize()
    want = ref.quantized_gathered_topk_ref(q, docs, scale, ids, min(depth + 1, r), n, bits, group)
    assert_topk_match([x.cpu() for x in got], [x.cpu() for x in want], exact=True)


@pytest.mark.gpu
def test_quantized_launch_plan_fills_the_card_at_both_batch_sizes():
    cuda_device()
    n = 2_999_808
    for bits in (8, 4):
        # every query dtype and width: the tensor-core plan
        for dtype, b, want in ((torch.bfloat16, 256, (64, 128)), (torch.bfloat16, 1, (8, 256)),
                               (torch.float32, 256, (64, 128)), (torch.float32, 1, (8, 256))):
            bq, k, splits, per, tile = quantized_plan(dtype, bits, b, n, 100, sm_count=132)
            n_tiles = -(-n // tile)
            assert (bq, tile, k) == want + (128,)
            assert -(-b // bq) * splits >= 132
            assert (splits - 1) * per < n_tiles <= splits * per  # no empty split
        # wide lists: 8-query tiles, then one stage of 128 docs, up to depth 3,136
        for dtype in (torch.bfloat16, torch.float32):
            assert quantized_plan(dtype, bits, 65, 5000, 3072, 132)[0] == 8
            assert quantized_plan(dtype, bits, 1, 5000, 3136, 132)[1:] == (3136, 40, 1, 128)
            with pytest.raises(ValueError, match="shared memory"):
                quantized_plan(dtype, bits, 1, 5000, 3137, 132)
    # an f32 query: 256-doc tiles only while the register loader's two
    # stages fit (over int8 rows too, where the 4-byte ring is smaller: rows
    # it cannot take use registers); over int4 rows, its only loader, with
    # their chunk scales
    for bits, depth, tile in ((8, 2112, 256), (8, 2144, 128), (8, 2272, 128), (4, 2080, 256),
                              (4, 2112, 128), (4, 2272, 128)):
        bq, _, _, _, got = quantized_plan(torch.float32, bits, 65, 5000, depth, 132)
        assert (bq, got) == (8, tile)


@pytest.mark.gpu
def test_quantized_kernels_raise_on_a_device_mix():
    dev = cuda_device()
    pq = builder.quantize_postings(torch.randn((300, 100), device=dev), 4, 32)
    q = torch.randn((3, 100), device=dev).to(torch.bfloat16)
    ids = torch.zeros((3, 64), dtype=torch.int32, device=dev)
    before = (fused_topk_quantized.launches, fused_topk_gathered_quantized.launches)
    with pytest.raises(ValueError, match="one CUDA device"):
        fused_topk_quantized(q.cpu(), pq.q, pq.scale, 10, 4, 32)
    with pytest.raises(ValueError, match="one CUDA device"):
        fused_topk_quantized(q, pq.q, pq.scale.cpu(), 10, 4, 32)
    with pytest.raises(ValueError, match="one CUDA device"):
        fused_topk_gathered_quantized(q, pq.q, pq.scale, ids.cpu(), 10, 300, 4, 32)
    assert (fused_topk_quantized.launches, fused_topk_gathered_quantized.launches) == before


def _on(index, dev):
    """The index container (and its quantized stores) with every tensor on
    ``dev``: the card searches the very arrays the CPU built."""
    return type(index)(**{
        f.name: (v.to(dev) if isinstance(v, torch.Tensor)
                 else _on(v, dev) if dataclasses.is_dataclass(v) else v)
        for f in dataclasses.fields(index) for v in [getattr(index, f.name)]})


@pytest.mark.gpu
@pytest.mark.parametrize("pp", ["int8", "int4"])
@pytest.mark.parametrize("method", ["classic", "dot", "bruteforce", "blockmax-classic",
                                    "blockmax-dot"])
def test_cuda_quantized_search_matches_cpu_port(method, pp):
    dev = cuda_device()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2000, 64)).astype(np.float32)
    q = x[:24] + 0.05 * rng.normal(size=(24, 64)).astype(np.float32)
    kind = method.split("-")[-1]
    cfg = BruteForceConfig() if kind == "bruteforce" else FakeWordsConfig(scoring=kind)
    keep = 3 if method.startswith("blockmax") else None
    cpu = AnnIndex.build(x, cfg, blockmax_keep=keep, blockmax_block_size=128,
                         primary_postings=pp, rerank_store="int8", device="cpu")
    gpu = AnnIndex(config=cfg, index=_on(cpu.index, dev), blockmax_keep=keep,
                   blockmax_block_size=128)
    assert gpu.device.type == "cuda" and gpu.quantized_rerank
    # The same arrays and the same query operand on both devices: f32 sums
    # in another order may only swap near-ties (torch_parity).
    qn = bruteforce.l2_normalize(torch.from_numpy(q))
    rep = cpu.pipeline.encoder(cpu.index, qn)
    got = gpu.pipeline.matcher(gpu.index, rep.to(dev), 100)
    want = cpu.pipeline.matcher(cpu.index, rep, 101)
    assert_topk_match([a.cpu() for a in got], want, exact=False)
    # the int8 rerank of the card's candidates, on the card and on the CPU
    got_rr = gpu.pipeline.reranker(gpu.index, qn.to(dev), got[1], 10)
    want_rr = cpu.pipeline.reranker(cpu.index, qn, got[1].cpu(), 11)
    assert_topk_match([a.cpu() for a in got_rr], want_rr, exact=False)
    s, i = gpu.search(q, k=10, depth=100, rerank=True)
    assert i.shape == (24, 10) and bool(torch.isfinite(s).all())


# ---- K6, K7, K8 (dense score matrices) and K9 (flash attention) ------------


def _off_16(x: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of ``x`` whose data start ``offset`` bytes past 16."""
    buf = torch.empty(x.numel() * x.element_size() + offset, dtype=torch.uint8, device=x.device)
    y = buf[offset:].view(x.dtype).view(x.shape)
    y.copy_(x)
    assert y.data_ptr() % 16 == offset and y.is_contiguous()
    return y


def _dense_operands(kind: str, b: int, n: int, t: int, dev: torch.device):
    """Operands of one dense score kernel; cosine's third is the docs'
    inverse norms; "-unaligned": the operands 1 (int8), 2 (bf16) or 4 (f32)
    bytes past 16, so they take the register loader."""
    if "-unaligned" in kind:
        q, d, inv = _dense_operands(kind.replace("-unaligned", ""), b, n, t, dev)
        off = q.element_size()
        return _off_16(q, off), _off_16(d, off), inv
    g = torch.Generator(device=dev).manual_seed(43)
    if kind == "lsh":  # the queries are doc rows: at least b of them, then the first n
        q, d = _operands("lsh", b, max(b, n), t, dev)
        d = d[:n].clone()
        d.view(torch.int32)[:, ::3] = -1  # doc sentinels too, some where the query's are
        return q, d, None
    if kind.startswith("int8"):
        return tuple(torch.randint(-128, 128, s, generator=g, device=dev, dtype=torch.int8)
                     for s in ((b, t), (n, t))) + (None,)
    if kind == "bf16":
        return _operands("bf16", b, n, t, dev) + (None,)
    q = torch.randn((b, t), generator=g, device=dev)
    d = torch.randn((n, t), generator=g, device=dev) * 3
    return q / q.norm(dim=1, keepdim=True), d, 1.0 / d.norm(dim=1)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,t", [(37, 3000, 257), (1, 1, 600), (70, 1000, 600),
                                   # K7's 128-query x 256-doc tile and its chunks
                                   # (32 bf16 / 64 int8 columns, a three-stage ring
                                   # where rows are 8-byte aligned) at their edges
                                   (127, 129, 63), (128, 255, 65), (129, 256, 129),
                                   (256, 257, 600), (129, 127, 128), (129, 128, 200),
                                   (256, 255, 392)])
@pytest.mark.parametrize("kind", ["bf16", "int8", "int8/int32", "f32", "lsh",
                                  "bf16-unaligned", "int8-unaligned", "int8-unaligned/int32"])
def test_cuda_dense_kernel_matches_plain_version(kind, b, n, t):
    from repro_torch.kernels.cosine_score import kernel as cos_kernel, ref as cos_ref
    from repro_torch.kernels.fakewords_score import kernel as fw_kernel, ref as fw_ref
    from repro_torch.kernels.lsh_match import kernel as lsh_kernel, ref as lsh_ref

    dev = cuda_device()
    q, d, inv = _dense_operands(kind, b, n, t, dev)
    if kind == "f32":
        fn, before = cos_kernel.cosine_scores, cos_kernel.cosine_scores.launches
        got, want = fn(q, d, inv), cos_ref.cosine_scores_ref(q, d, inv)
    elif kind == "lsh":
        fn, before = lsh_kernel.lsh_match_scores, lsh_kernel.lsh_match_scores.launches
        got, want = fn(q, d), lsh_ref.lsh_match_scores_ref(q, d)
    else:
        out = torch.int32 if kind.endswith("/int32") else torch.float32
        fn, before = fw_kernel.score_matmul, fw_kernel.score_matmul.launches
        got, want = fn(q, d, out), fw_ref.score_matmul_ref(q, d, out)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.dtype == want.dtype and got.shape == (b, n)
    if kind.startswith(("bf16", "f32")):
        assert_rows_close(got, want, 1e-5)
    else:
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,s", [
    # K8's query tiles of 1, 2, 4 and 8 rows at B <= 8 (B = 5: three padded
    # rows) and of 64 from B = 9 (B = 65: one row in the second tile), its
    # 256- and 128-doc tiles at their edges, S of 1, 37 and 1,500 (4-byte
    # copies at S = 1 and 37, 47 chunks at 1,500) and N = 1
    (1, 3000, 300), (1, 1, 1), (2, 257, 37), (5, 513, 1), (8, 1000, 1500), (9, 129, 300),
    (65, 1000, 37), (65, 255, 1500), (65, 1, 300)])
@pytest.mark.parametrize("kind", ["lsh", "lsh-unaligned"])
def test_cuda_lsh_match_scores_matches_plain_version(kind, b, n, s):
    """K8 against its plain version, bit for bit; "lsh-unaligned": rows 4
    bytes off 16 (the ring's 4-byte copies)."""
    from repro_torch.kernels.lsh_match import kernel as lsh_kernel, ref as lsh_ref

    dev = cuda_device()
    q, d, _ = _dense_operands(kind, b, n, s, dev)
    before = lsh_kernel.lsh_match_scores.launches
    got = lsh_kernel.lsh_match_scores(q, d)
    torch.cuda.synchronize()
    assert lsh_kernel.lsh_match_scores.launches == before + 1
    assert torch.equal(got, lsh_ref.lsh_match_scores_ref(q, d))


@pytest.mark.gpu
def test_lsh_match_plan_fills_the_card():
    """K8's plan (lsh_match_plan): the query tile of 1, 2, 4 or 8 rows that
    holds B at B <= 8 (no padded row compares) and 64 rows from B = 9; query
    tiles x splits fill every SM's resident blocks (two a SM at 64 queries,
    one below) at B = 256 and at B = 1, with no empty split; S >= 2^24 is
    refused (f32 counts)."""
    from repro_torch.kernels.lsh_match.kernel import plan

    cuda_device()
    n = 2_999_808
    for b, bq_want in ((1, 1), (2, 2), (3, 4), (4, 4), (5, 8), (8, 8), (9, 64), (256, 64)):
        bq, splits, per, tile, blocks = plan(b, n, 300, 132)
        assert (bq, tile, blocks) == (bq_want, 128 if bq == 64 else 256, 2 if bq == 64 else 1)
        n_tiles = -(-n // tile)
        assert (splits - 1) * per < n_tiles <= splits * per  # no empty split
        assert 0.95 * blocks * 132 <= -(-b // bq) * splits <= blocks * 132
    assert plan(1, 1, 1, 132)[1:3] == (1, 1)
    with pytest.raises(ValueError):
        plan(1, 10, 1 << 24, 132)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,t", [
    # K6's 128-query x 128-doc tile at its edges, its 8-column k-steps and
    # 16-column chunks (T = 15..17), the cosine's T = 300, its queries
    # resident up to 384 columns (T = 320, 321, 384) and streamed past them
    # (T = 385, 600)
    (127, 129, 15), (129, 127, 16), (256, 257, 17), (129, 128, 300), (127, 255, 320),
    (256, 256, 321), (129, 257, 384), (128, 129, 385), (256, 127, 600)])
@pytest.mark.parametrize("kind", ["f32", "f32-unaligned"])
def test_cuda_cosine_scores_at_tile_and_chunk_edges(kind, b, n, t):
    """K6 (split TF32 on tensor cores) against its plain version under the
    1e-5 row rule; "f32-unaligned": rows 4 bytes off 16, the register
    loader."""
    from repro_torch.kernels.cosine_score import kernel as cos_kernel, ref as cos_ref

    dev = cuda_device()
    q, d, inv = _dense_operands(kind, b, n, t, dev)
    before = cos_kernel.cosine_scores.launches
    got = cos_kernel.cosine_scores(q, d, inv)
    torch.cuda.synchronize()
    assert cos_kernel.cosine_scores.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (b, n)
    assert_rows_close(got, cos_ref.cosine_scores_ref(q, d, inv), 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,s", [(4, 4, 1), (4, 2, 130), (8, 1, 300),
                                     # the bf16 kernel's 64-key and 128-row tile edges
                                     (4, 4, 63), (4, 2, 64), (8, 1, 65), (4, 4, 127),
                                     (4, 2, 128), (8, 1, 129),
                                     (7, 1, 4096)])  # GQA group 7, deepseek-coder-33b's
def test_cuda_flash_attention_matches_plain_version(hq, hkv, s, dtype, d):
    from repro_torch.kernels.flash_attention import kernel, ref

    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(s + d)
    q, k, v = (torch.randn((2, h, s, d), generator=g, device=dev).to(dtype)
               for h in (hq, hkv, hkv))
    before = kernel.flash_attention.launches
    got = kernel.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert kernel.flash_attention.launches == before + 1
    want = ref.attention_ref(q, k, v)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    assert_rows_close(got, want, tol)


@pytest.mark.gpu
def test_cuda_flash_attention_takes_bf16_operands_off_16_bytes():
    """The bf16 kernel copies 16-byte packs; operands whose data start 2
    bytes past that are copied first, and the output is the same."""
    from repro_torch.kernels.flash_attention import kernel

    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(11)
    n = 4 * 130 * 64
    flat = torch.randn(3 * n + 1, generator=g, device=dev).bfloat16()
    q, k, v = (flat[1 + i * n:1 + (i + 1) * n].view(1, 4, 130, 64) for i in range(3))
    assert q.data_ptr() % 16 and q.is_contiguous()
    got = kernel.flash_attention(q, k, v)
    want = kernel.flash_attention(q.clone(), k.clone(), v.clone())
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_cuda_flash_attention_takes_f32_operands_off_16_bytes():
    """The f32 kernel copies 16-byte packs too; operands whose data start 4
    bytes past that are copied first, and the output is the same."""
    from repro_torch.kernels.flash_attention import kernel

    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(12)
    n = 4 * 130 * 96
    flat = torch.randn(3 * n + 1, generator=g, device=dev)
    q, k, v = (flat[1 + i * n:1 + (i + 1) * n].view(1, 4, 130, 96) for i in range(3))
    assert q.data_ptr() % 16 == 4 and q.is_contiguous()
    got = kernel.flash_attention(q, k, v)
    want = kernel.flash_attention(q.clone(), k.clone(), v.clone())
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# Faults planted in copies of both attention kernels (flash_attention_bf16
# and flash_attention_tf32; each fault's edits hit each kernel once) that
# only rows past 2,048 see (the 128-row blocks with more than 32 KV tiles of
# 64 keys): one KV tile skipped, one rescale of the running output left out
# (the f32 kernel rescales in its fold), the denominator 3% off.  Each
# changes a late row by much less than the largest |output|, which sits in
# the first rows.
ATTENTION_FAULTS = {
    "skip_middle_kv_tile": [(
        "    float s[kKeyFrags][4];\n",
        "    if (n_tiles > 32 && t == n_tiles / 2) continue;\n    float s[kKeyFrags][4];\n")],
    "skip_one_rescale": [
        ("        o[j][e] *= alpha[e >> 1];\n",
         "        o[j][e] *= (n_tiles > 32 && t == n_tiles / 2) ? 1.f : alpha[e >> 1];\n"),
        ("o[j][e] = fmaf(o[j][e], alpha[e >> 1], pv[j][e]);",
         "o[j][e] = fmaf(o[j][e], (n_tiles > 32 && t == n_tiles / 2) ? 1.f : alpha[e >> 1], "
         "pv[j][e]);")],
    "denominator_3pct_off": [(
        "    const float denom = fmaxf(l[r], 1e-30f);\n",
        "    const float denom = fmaxf(l[r], 1e-30f) * (row >= 2048 ? 1.03f : 1.f);\n")],
}


@pytest.mark.gpu
def test_cuda_attention_check_catches_planted_faults(tmp_path, monkeypatch):
    """The row-scaled comparison that holds K9 to its plain version (here
    and in chip_smoke.compare_dense) passes the kernels and fails each of
    ATTENTION_FAULTS, built from a copy of the source under ``tmp_path``,
    on a GQA layer at S = 4096 in bf16 (1e-2) and in f32 (1e-4); each
    copy's first 2,048 rows equal the kernel's bit for bit."""
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention import kernel, ref

    dev = cuda_device()
    src = common.SOURCES["flash_attention"]
    text = src.read_text()
    monkeypatch.setattr(common, "BUILD_DIR", tmp_path / "build")
    for name, edits in ATTENTION_FAULTS.items():
        assert sum(text.count(old) for old, _ in edits) == 2, name  # once in each kernel
        faulty = text
        for old, new in edits:
            faulty = faulty.replace(old, new)
        (tmp_path / name).mkdir()
        (tmp_path / name / src.name).write_text(faulty)
        monkeypatch.setitem(common.SOURCES, name, tmp_path / name / src.name)
    common.build(["flash_attention", *ATTENTION_FAULTS])  # one nvcc each, in parallel
    g = torch.Generator(device=dev).manual_seed(7)
    layers = {}
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        qkv = tuple(torch.randn((1, h, 4096, 128), generator=g, device=dev).to(dtype)
                    for h in (8, 2, 2))
        layers[dtype] = (qkv, tol, ref.attention_ref(*qkv))
    good = {}
    try:
        for name in ("flash_attention", *ATTENTION_FAULTS):
            monkeypatch.setitem(common.SOURCES, "flash_attention", common.SOURCES[name])
            common.load_library.cache_clear()
            kernel._lib.cache_clear()
            for dtype, ((q, k, v), tol, want) in layers.items():
                got = kernel.flash_attention(q, k, v)
                if name == "flash_attention":
                    assert_rows_close(got, want, tol)
                    good[dtype] = got
                    continue
                assert torch.equal(got[:, :, :2048], good[dtype][:, :, :2048]), (name, dtype)
                with pytest.raises(AssertionError) as fault:
                    assert_rows_close(got, want, tol)
                print(f"{name}, {dtype}: {fault.value}")
    finally:  # the next call loads the unchanged library again
        common.load_library.cache_clear()
        kernel._lib.cache_clear()


@pytest.mark.gpu
def test_cuda_dense_score_and_attention_entry_points_match_cpu_port():
    """cosine_topk, classic_scores / dot_scores, lsh_topk and
    causal_attention on the card against the same calls on the CPU."""
    from repro_torch.core import fakewords, lexical_lsh
    from repro_torch.kernels.cosine_score import cosine_topk
    from repro_torch.kernels.fakewords_score import classic_scores, dot_scores
    from repro_torch.kernels.flash_attention import causal_attention
    from repro_torch.kernels.lsh_match import lsh_topk

    dev = cuda_device()
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(2000, 64)).astype(np.float32))
    q = x[:24] + 0.05
    assert_topk_match([a.cpu() for a in cosine_topk(q.to(dev), x.to(dev), 10)],
                      cosine_topk(q, x, 11), exact=False)
    for scoring in ("classic", "dot"):
        cfg = FakeWordsConfig(scoring=scoring)
        cpu = AnnIndex.build(x, cfg, device="cpu")
        gpu = AnnIndex(config=cfg, index=_on(cpu.index, dev))
        q_tf = fakewords.encode_queries(q, cfg)
        fn = classic_scores if scoring == "classic" else dot_scores
        got, want = fn(gpu.index, q_tf.to(dev)).cpu(), fn(cpu.index, q_tf)
        if scoring == "dot":
            assert torch.equal(got, want)
        else:
            assert_rows_close(got, want, 1e-5)
    lcfg = LexicalLshConfig(buckets=64, hashes=2)
    lidx = AnnIndex.build(x, lcfg, device="cpu")
    sig_q = lexical_lsh.encode(q, lcfg)
    got = lsh_topk(_on(lidx.index, dev), sig_q.to(dev), 50)
    want = lsh_topk(lidx.index, sig_q, 50)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    t = [torch.from_numpy(rng.normal(size=(1, h, 200, 96)).astype(np.float32)) for h in (8, 2, 2)]
    got = causal_attention(*(a.to(dev).bfloat16() for a in t)).float().cpu()
    want = causal_attention(*(a.bfloat16() for a in t)).float()
    assert_rows_close(got, want, 1e-2)


# ---- the k-d tree (the lifted scan on K1 f32, the tree DFS) and persistence ---


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [8, 4])
@pytest.mark.parametrize("reduction", ["pca", "ppa-pca-ppa"])
def test_cuda_kd_scan_matches_cpu_port(reduction, dims):
    """The scan backend on the card (K1 f32 at T = dims + 1) against the CPU
    route over the same arrays and reduced queries, at B = 1, 8 and 256;
    then the whole search, built on the card."""
    from repro_torch.core import kdtree

    dev = cuda_device()
    rng = np.random.default_rng(dims)
    x = rng.normal(size=(5000, 64)).astype(np.float32)
    q = x[:256] + 0.05 * rng.normal(size=(256, 64)).astype(np.float32)
    cfg = KdTreeConfig(dims=dims, reduction=reduction)
    cpu = AnnIndex.build(x, cfg, device="cpu")
    gpu = AnnIndex(config=cfg, index=_on(cpu.index, dev))
    qr = kdtree.reduce_queries(cpu.index, torch.from_numpy(q))
    for b in (1, 8, 256):
        before = fused_topk.launches
        got = gpu.pipeline.matcher(gpu.index, qr[:b].to(dev), 100)
        torch.cuda.synchronize()
        assert fused_topk.launches == before + 1
        want = cpu.pipeline.matcher(cpu.index, qr[:b], 101)
        assert_topk_match([a.cpu() for a in got], want, exact=False)
    # built on the card (its own fit: eigh's signs and last bits are the
    # card's), then searched there and, over the same arrays, on the CPU
    built = AnnIndex.build(x, cfg)
    assert built.device.type == "cuda" and built.index.lifted.shape == (5000, dims + 1)
    back = AnnIndex(config=cfg, index=_on(built.index, torch.device("cpu")))
    got = built.search(q[:24], k=10, depth=100)
    assert_topk_match([a.cpu() for a in got], back.search(q[:24], k=11, depth=101), exact=False)
    got = built.search(q[:24], k=10, depth=100, rerank=True)
    want = back.search(q[:24], k=10, depth=100, rerank=True)
    assert float(ev.overlap(want[1], got[1].cpu())) >= 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("reduction", ["pca", "ppa-pca-ppa"])
def test_cuda_kd_tree_matches_scan_and_cpu(reduction):
    """The lock-step DFS on the card: ids equal to the CPU's DFS over the
    same arrays, and to the card's scan under the near-tie rule (the scan's
    score is the tree's plus ||q||^2)."""
    from repro_torch.core import kdtree

    dev = cuda_device()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(20_000, 64)).astype(np.float32)
    cfg = KdTreeConfig(dims=8, reduction=reduction, backend="tree")
    cpu = AnnIndex.build(x, cfg, device="cpu")
    gpu_index = _on(cpu.index, dev)
    qr = kdtree.reduce_queries(cpu.index, torch.from_numpy(x[:8] + 0.05))
    for k in (10, 100):
        s, i = kdtree.tree_search(gpu_index, qr.to(dev), k)
        want = kdtree.tree_search(cpu.index, qr, k)
        assert_topk_match([s.cpu(), i.cpu()], want, exact=False)
        scan = kdtree.scan_search(gpu_index, qr.to(dev), k + 1)
        shift = (qr * qr).sum(-1, keepdim=True)
        assert_topk_match([s.cpu() + shift, i.cpu()], [scan[0].cpu(), scan[1].cpu()],
                          exact=False)


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["kdtree-tree", "kdtree-scan", "classic-int8", "lsh"])
def test_cuda_save_and_load_round_trip(tmp_path, method):
    dev = cuda_device()
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3000, 64)).astype(np.float32)
    q = x[:16] + 0.05
    knobs = {}
    if method.startswith("kdtree"):
        cfg = KdTreeConfig(dims=8, backend=method.split("-")[1], reduction="ppa-pca-ppa")
    elif method == "lsh":
        cfg = LexicalLshConfig(buckets=64, hashes=2)
        knobs = {"blockmax_keep": 4, "blockmax_block_size": 128}
    else:
        cfg = FakeWordsConfig()
        knobs = {"primary_postings": "int8", "rerank_store": "int8"}
    idx = AnnIndex.build(x, cfg, **knobs)
    idx.save(str(tmp_path / "idx"))
    loaded = AnnIndex.load(str(tmp_path / "idx"))
    assert loaded.device == dev and loaded.config == idx.config
    assert loaded.blockmax_keep == idx.blockmax_keep and loaded.nbytes() == idx.nbytes()
    for rerank in (False, True):
        s0, i0 = idx.search(q, k=10, depth=100, rerank=rerank)
        s1, i1 = loaded.search(q, k=10, depth=100, rerank=rerank)
        assert torch.equal(i0, i1) and torch.equal(s0, s1)
    cpu = AnnIndex.load(str(tmp_path / "idx"), device="cpu")
    assert cpu.device.type == "cpu" and cpu.nbytes() == idx.nbytes()


# ---- filtered search: the facade's masks through K1-K5 and the tree DFS ----

FILTERED_METHODS = {  # method -> (config, build knobs, blockmax_keep, integer scores)
    "classic": (FakeWordsConfig(), {}, None, False),
    "dot": (FakeWordsConfig(scoring="dot"), {}, None, True),
    "classic-int8": (FakeWordsConfig(), {"primary_postings": "int8", "rerank_store": "int8"},
                     None, False),
    "classic-int4": (FakeWordsConfig(), {"primary_postings": "int4", "rerank_store": "int8"},
                     None, False),
    "bruteforce": (BruteForceConfig(), {}, None, False),
    "bruteforce-int8": (BruteForceConfig(), {"primary_postings": "int8"}, None, False),
    "lsh": (LexicalLshConfig(buckets=64, hashes=2), {}, None, True),
    "kdtree-scan": (KdTreeConfig(dims=8), {}, None, False),
    "kdtree-tree": (KdTreeConfig(dims=8, backend="tree"), {}, None, False),
    "blockmax-classic": (FakeWordsConfig(), {}, 6, False),
    "blockmax-dot": (FakeWordsConfig(scoring="dot"), {}, 6, True),
    "blockmax-lsh": (LexicalLshConfig(buckets=64, hashes=2), {}, 6, True),
    "blockmax-classic-int4": (FakeWordsConfig(), {"primary_postings": "int4",
                                                  "rerank_store": "int8"}, 6, False),
}


def _filtered_pair(method: str, n: int = 3000):
    """The method's index built on the CPU and the same arrays on the card,
    and 16 queries."""
    dev = cuda_device()
    cfg, knobs, keep, exact = FILTERED_METHODS[method]
    rng = np.random.default_rng(6)
    x = rng.normal(size=(n, 64)).astype(np.float32)
    q = x[:16] + 0.05 * rng.normal(size=(16, 64)).astype(np.float32)
    cpu = AnnIndex.build(x, cfg, blockmax_keep=keep, blockmax_block_size=128, device="cpu",
                         **knobs)
    gpu = AnnIndex(config=cfg, index=_on(cpu.index, dev), blockmax_keep=keep,
                   blockmax_block_size=128, quantized_rerank=cpu.quantized_rerank)
    return cpu, gpu, q, exact


def _masks(n: int, b: int):
    """Shared masks at 1% / 10% / 50%, one of exactly 50 docs, and a (B, N)
    one, as int32 (nonzero = keep)."""
    g = torch.Generator().manual_seed(8)
    out = {f"{r:.0%}": (torch.rand(n, generator=g) < r).to(torch.int32) for r in (0.01, 0.1, 0.5)}
    fifty = torch.zeros(n, dtype=torch.int32)
    fifty[torch.randperm(n, generator=g)[:50]] = 1
    out["50 docs"] = fifty
    out["per query"] = (torch.rand((b, n), generator=g) < 0.3).to(torch.int32)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("method", list(FILTERED_METHODS))
def test_cuda_filtered_search_matches_cpu_port(method):
    """Each encoding's filtered search on the card (int32 masks, shared and
    per query, moved to the card by the facade) against the CPU route over
    the same arrays: integer scores bit for bit, float ones under the
    near-tie rule; every id kept; a mask of 50 docs at depth 100 gives them,
    then (-inf, -1) (where every doc is scored: not blockmax, not the tree's
    post-filter)."""
    cpu, gpu, q, exact = _filtered_pair(method)
    n = cpu.num_docs
    tree = method == "kdtree-tree"
    for name, m in _masks(n, q.shape[0]).items():
        for mask in (m, m.cuda(), m.cuda() != 0):
            got = [a.cpu() for a in gpu.search(q, k=100, depth=100, filt=mask)]
            width = 100 if exact or tree else 101
            want = cpu.search(q, k=width, depth=width, filt=m)
            assert_topk_match(got, want, exact=exact)
            keep = m if m.dim() == 2 else m.expand(q.shape[0], n)
            ids = got[1]
            assert bool(((ids < 0) | (torch.gather(keep, 1, ids.clamp_min(0).long()) != 0)).all())
            assert not bool(got[0].isnan().any()), name
        if name == "50 docs" and cpu.bm is None and not tree:
            assert (got[1][:, :50] >= 0).all() and (got[1][:, 50:] == -1).all()
            assert (got[0][:, 50:] == -torch.inf).all()
    zeros = torch.zeros(n, dtype=torch.int32, device="cuda")
    for rerank in (False, True):
        s, i = gpu.search(q, k=10, depth=100, rerank=rerank, filt=zeros)
        assert (i == -1).all() and (s == -torch.inf).all()
    ones = torch.ones(n, dtype=torch.bool, device="cuda")
    s0, i0 = gpu.search(q, k=10, depth=100)
    s1, i1 = gpu.search(q, k=10, depth=100, filt=ones)
    assert torch.equal(s0, s1) and torch.equal(i0, i1)


@pytest.mark.gpu
def test_cuda_masks_of_any_dtype_and_the_kernels_own_check():
    """The facade takes bool, uint8 and int32 masks on the card alike and
    refuses a wrong shape; the kernel wrappers still take only contiguous
    bool / uint8 (their own TypeError)."""
    cpu, gpu, q, _ = _filtered_pair("classic")
    m = _masks(cpu.num_docs, q.shape[0])["10%"].cuda()
    base = gpu.search(q, k=10, depth=100, filt=m)
    for other in (m != 0, m.to(torch.uint8), m.cpu().numpy(), m[None].expand(16, -1)):
        got = gpu.search(q, k=10, depth=100, filt=other)
        assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])
    with pytest.raises(ValueError, match="filter mask"):
        gpu.search(q, k=10, depth=100, filt=m[:-1])
    qv = torch.randn((4, 64), device="cuda")
    docs = torch.randn((cpu.num_docs, 64), device="cuda")
    with pytest.raises(TypeError, match="bool or uint8"):
        fused_topk(qv, docs, 10, filt=m)


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["blockmax-classic", "blockmax-classic-int4"])
def test_cuda_filtered_blockmax_every_block_equals_dense(method):
    """Filtered blockmax on the card (K3 / K5 with the gathered mask) at
    every block kept equals the card's dense filtered search, and at 3 of 24
    blocks the CPU route's."""
    cpu, gpu, q, _ = _filtered_pair(method)
    n = cpu.num_docs
    dense = AnnIndex(config=gpu.config, index=gpu.index)
    every = AnnIndex(config=gpu.config, index=gpu.index, blockmax_keep=gpu.bm.num_blocks,
                     blockmax_block_size=128)
    for name, m in _masks(n, q.shape[0]).items():
        mc = m.cuda()
        got = [a.cpu() for a in every.search(q, k=100, depth=100, filt=mc)]
        assert_topk_match(got, [a.cpu() for a in dense.search(q, k=101, depth=101, filt=mc)],
                          exact=False)
        got = [a.cpu() for a in gpu.search(q, k=100, depth=100, filt=mc)]
        assert_topk_match(got, cpu.search(q, k=101, depth=101, filt=m), exact=False)


@pytest.mark.gpu
def test_cuda_filter_mask_native_equals_inflated():
    """FilterMask on the card: the mask in the kernel (native) gives the
    ids of depth inflation (extra = 1,024) at the 50% mask, under the
    near-tie rule (the two calls run K1 at other depths, so other plans)."""
    from repro_torch.core import fakewords
    from repro_torch.core import pipeline as pl

    cpu, gpu, q, _ = _filtered_pair("classic")
    m = _masks(cpu.num_docs, q.shape[0])["50%"].cuda()
    q_tf = fakewords.encode_queries(bruteforce.l2_normalize(torch.from_numpy(q).cuda()),
                                    gpu.config)
    fm = pl.FilterMask(inner=gpu.pipeline.matcher, extra=1024)
    native = [a.cpu() for a in fm(gpu.index, q_tf, 100, m, native=True)]
    inflated = [a.cpu() for a in fm(gpu.index, q_tf, 101, m, native=False)]
    assert_topk_match(native, inflated, exact=False)


# --------------------------------------------------------------------------
# Segments and the packed single launch on the card
# --------------------------------------------------------------------------

SEGMENTED_METHODS = {  # config, writer knobs, integer scores
    "classic": (FakeWordsConfig(quantization=50), {}, False),
    "dot-int8": (FakeWordsConfig(quantization=50, scoring="dot"),
                 {"primary_postings": "int8", "rerank_store": "int8"}, True),
    "classic-int4": (FakeWordsConfig(quantization=50), {"primary_postings": "int4"}, False),
    "lsh": (LexicalLshConfig(buckets=64, hashes=2), {}, True),
    "kdtree-scan": (KdTreeConfig(dims=8), {}, False),
    "bruteforce": (BruteForceConfig(), {}, False),
}


def _segmented(method: str, device, n_segments: int = 4, rows: int = 1500, dim: int = 64):
    from repro_torch.core.segments import IndexWriter

    cfg, knobs, _ = SEGMENTED_METHODS[method]
    rng = np.random.default_rng(17)
    w = IndexWriter(cfg, merge_policy=None, device=device, **knobs)
    for _ in range(n_segments):
        w.add(rng.normal(size=(rows, dim)).astype(np.float32))
        w.flush()
    w.delete(rng.choice(w.total_docs, size=w.total_docs // 100, replace=False))
    return w, rng.normal(size=(8, dim)).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("method", list(SEGMENTED_METHODS))
def test_cuda_packed_equals_loop_and_cpu_port(method):
    """A segmented index with deletes on the card: the packed single launch
    equals the per-segment loop bit for bit (the same rows, the same
    kernels), with and without rerank and a predicate; both equal a
    monolithic build of the live rows on the card (integer modes and
    classic bit for bit, f32 under the near-tie rule) and the CPU route's
    (integer modes bit for bit, float modes under the near-tie rule).  The
    int4 classic store is quantized on each device from a ``scored`` whose
    idf comes from that device's ``log``: an ulp there moves a nibble, so
    against the CPU route it is held to 90% id overlap."""
    dev = cuda_device()
    gw, q = _segmented(method, dev)
    cw, _ = _segmented(method, "cpu")
    gpu, cpu = gw.refresh(), cw.refresh()
    cfg, knobs, exact = SEGMENTED_METHODS[method]
    rows = np.concatenate([s.source_rows()[torch.from_numpy(s.live).to(dev)].cpu().numpy()
                           for s in gpu.segments])
    mono = AnnIndex.build(rows, cfg, normalized=True, device=dev, **knobs)
    gmap = gpu.live_global_ids()
    pred = np.random.default_rng(3).random(gpu.max_doc) < 0.5
    for fm in (None, pred):
        for rerank in (False, True):
            kw = dict(k=10, depth=100, rerank=rerank, filter_mask=fm)
            packed = [a.cpu() for a in gpu.search(q, packed=True, **kw)]
            loop = [a.cpu() for a in gpu.search(q, packed=False, **kw)]
            assert torch.equal(packed[0], loop[0]) and torch.equal(packed[1], loop[1])
            want = cpu.search(q, packed=False, **kw)
            if method == "classic-int4":
                assert float(ev.overlap(want[1], packed[1])) >= 0.9
            else:
                assert_topk_match(packed, want, exact=exact and not rerank)
            if fm is None:
                ms, mi = (a.cpu().numpy() for a in mono.search(q, k=10, depth=100,
                                                               rerank=rerank))
                mi = np.where(mi >= 0, gmap[np.maximum(mi, 0)], -1)
                assert_topk_match(packed, (ms, mi),
                                  exact=method not in ("kdtree-scan", "bruteforce"))


def _replays(monkeypatch) -> list:
    count = [0]
    replay = torch.cuda.CUDAGraph.replay

    def counted(self):
        count[0] += 1
        return replay(self)

    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", counted)
    return count


@pytest.mark.gpu
def test_cuda_graph_cache_hits_across_an_in_place_append(monkeypatch):
    """LSH (stats-static): the first packed search captures a graph; an
    append-only refresh writes into the same buffers, so the next search
    replays that graph (a hit, no capture) and equals the loop."""
    from repro_torch.core import packed as packed_mod
    from repro_torch.core.segments import IndexWriter

    dev = cuda_device()
    rng = np.random.default_rng(5)
    cache = packed_mod.EXEC_CACHE
    cache.clear()
    replays = _replays(monkeypatch)
    w = IndexWriter(LexicalLshConfig(buckets=64, hashes=2), merge_policy=None, device=dev)
    w.add(rng.normal(size=(5000, 32)).astype(np.float32))
    q = rng.normal(size=(8, 32)).astype(np.float32)
    w.refresh().search(q, packed=True)
    assert cache.compiles == 1 and replays[0] == 1
    for cycle in range(3):
        w.add(rng.normal(size=(100, 32)).astype(np.float32))
        reader = w.refresh()
        s, i = reader.search(q, packed=True)
        assert reader.packed_segments().appends == cycle + 1
        assert cache.compiles == 1 and cache.hits == cycle + 1 and replays[0] == cycle + 2
        s0, i0 = reader.search(q, packed=False)
        assert torch.equal(i.cpu(), i0.cpu()) and torch.equal(s.cpu(), s0.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["lsh-no-rung", "classic"])
def test_cuda_full_repack_captures_anew(method, monkeypatch):
    """A full repack (no append rung fits, or classic's new statistics)
    allocates new buffers: the search must miss and capture a new graph,
    never replay one over the old buffers."""
    from repro_torch.core import packed as packed_mod
    from repro_torch.core.segments import IndexWriter

    dev = cuda_device()
    rng = np.random.default_rng(6)
    cache = packed_mod.EXEC_CACHE
    cache.clear()
    if method == "lsh-no-rung":  # 762 rows -> bucket 768: 5 more fit, no 8-row rung does
        w = IndexWriter(LexicalLshConfig(buckets=64, hashes=2), merge_policy=None, device=dev)
        first, more = 762, 5
    else:
        w = IndexWriter(FakeWordsConfig(quantization=50), merge_policy=None, device=dev)
        first, more = 3000, 200
    w.add(rng.normal(size=(first, 32)).astype(np.float32))
    q = rng.normal(size=(8, 32)).astype(np.float32)
    w.refresh().search(q, packed=True)
    w.add(rng.normal(size=(more, 32)).astype(np.float32))
    reader = w.refresh()
    s, i = reader.search(q, packed=True)
    assert reader.packed_segments().appends == 0
    assert cache.compiles == 2 and cache.hits == 0
    s0, i0 = reader.search(q, packed=False)
    assert torch.equal(i.cpu(), i0.cpu()) and torch.equal(s.cpu(), s0.cpu())


@pytest.mark.gpu
def test_cuda_graphs_go_with_their_pack():
    """Classic refresh cycles repack fully and capture a new graph each;
    a dead pack's graph (with its memory pool) is freed with the pack, so
    the cache holds the live snapshot's graph alone."""
    import weakref

    from repro_torch.core import packed as packed_mod
    from repro_torch.core.segments import IndexWriter

    dev = cuda_device()
    rng = np.random.default_rng(8)
    cache = packed_mod.EXEC_CACHE
    cache.clear()
    w = IndexWriter(FakeWordsConfig(quantization=50), merge_policy=None, device=dev)
    w.add(rng.normal(size=(3000, 32)).astype(np.float32))
    q = rng.normal(size=(64, 32)).astype(np.float32)
    graphs = []
    for _ in range(4):
        w.add(rng.normal(size=(10, 32)).astype(np.float32))
        reader = w.refresh()
        reader.search(q, k=10, depth=100, rerank=True, packed=True)
        assert cache.stats()["entries"] == 1, cache.stats()
        graphs.append(weakref.ref(next(iter(cache._entries.values()))))
    assert cache.compiles == 4
    assert [g() is None for g in graphs] == [True, True, True, False]
    del reader
    w._reader = None
    assert cache.stats()["entries"] == 0 and graphs[-1]() is None


@pytest.mark.gpu
def test_cuda_no_stale_graph_over_a_donated_prior():
    """After an append spends the old snapshot's pack, searching the old
    reader again repacks it into new buffers (a miss) and returns ITS
    results, not the new snapshot's; the new reader keeps its own."""
    from repro_torch.core.segments import IndexWriter

    dev = cuda_device()
    rng = np.random.default_rng(7)
    w = IndexWriter(LexicalLshConfig(buckets=64, hashes=2), merge_policy=None, device=dev)
    w.add(rng.normal(size=(4000, 32)).astype(np.float32))
    q = rng.normal(size=(8, 32)).astype(np.float32)
    r0 = w.refresh()
    r0.search(q, packed=True)
    w.add(q * 3.0)  # exact matches of every query: the new snapshot's top hits
    r1 = w.refresh()
    s1, i1 = r1.search(q, packed=True)
    assert r1.packed_segments().appends == 1 and r0._packed is None
    assert (i1[:, 0].cpu() >= 4000).all()
    s0, i0 = r0.search(q, packed=True)
    assert r0.packed_segments().appends == 0
    assert (i0 < 4000).all()
    l0 = r0.search(q, packed=False)
    assert torch.equal(i0.cpu(), l0[1].cpu()) and torch.equal(s0.cpu(), l0[0].cpu())
    l1 = r1.search(q, packed=False)
    assert torch.equal(i1.cpu(), l1[1].cpu())


# -- the proximity graph ("hnsw") ----------------------------------------------


def _graph_ints(n: int, t: int, seed: int):
    """Integer-valued rows in {-2, ..., 2} (every f32 product and sum exact,
    split TF32 too) with some duplicate rows, as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2, 3, size=(n, t)).astype(np.float32)
    dup = min(50, n // 4)
    x[n // 2:n // 2 + dup] = x[:dup]
    return x


@pytest.mark.gpu
def test_cuda_graph_integer_build_and_search_equal_cpu_route():
    """K1's pools and K3's blocks on integer-valued rows: the build
    (adjacency, entry points) and the search (ids, scores, scored rows, with
    and without a mask) on the card equal the CPU route's bit for bit."""
    from repro_torch.core import graph
    from repro_torch.core.types import GraphConfig

    dev = cuda_device()
    x = _graph_ints(6000, 48, seed=1)
    q = _graph_ints(40, 48, seed=2)
    cfg = GraphConfig(ef=48, beam=4)
    xc, xg = torch.from_numpy(x), torch.from_numpy(x).to(dev)
    m = cfg.ef_construction
    pools_c, pools_g = graph._knn_pools(xc, m), graph._knn_pools(xg, m)
    for c, g in zip(pools_c, pools_g):
        assert torch.equal(g.cpu(), c), "pools"
    fwd_c = graph._prune_all(*pools_c, xc, cfg.degree, cfg.alpha)
    fwd_g = graph._prune_all(*pools_g, xg, cfg.degree, cfg.alpha)
    for c, g in zip(fwd_c, fwd_g):
        assert torch.equal(g.cpu(), c), "prune"
    rev_c = graph._reverse_edges(fwd_c[1], fwd_c[0], 6000, cfg.reverse_degree)
    rev_g = graph._reverse_edges(fwd_g[1], fwd_g[0], 6000, cfg.reverse_degree)
    assert torch.equal(rev_g.cpu(), rev_c), "reverse edges"
    assert torch.equal(graph._entry_points(xg, cfg.entries).cpu(),
                       graph._entry_points(xc, cfg.entries)), "entry points"
    nb_c, e_c = graph.build_graph(xc, cfg)
    nb_g, e_g = graph.build_graph(xg, cfg)
    assert torch.equal(nb_g.cpu(), nb_c) and torch.equal(e_g.cpu(), e_c)
    mask = torch.from_numpy(np.random.default_rng(3).random(6000) < 0.3)
    for filt in (None, mask):
        want = graph.search_graph(torch.from_numpy(x), nb_c, e_c, torch.from_numpy(q), 30,
                                  ef=cfg.ef, beam=cfg.beam, iters=cfg.search_iters,
                                  n_docs=6000, filt=filt, with_stats=True)
        args = (torch.from_numpy(x).to(dev), nb_g, e_g, torch.from_numpy(q).to(dev),
                None if filt is None else filt.to(dev))
        knobs = dict(ef=cfg.ef, beam=cfg.beam, iters=cfg.search_iters, n_docs=6000)
        eager = graph._traverse(*args, depth=30, **knobs)  # op by op
        captured = graph.search_graph(*args[:4], 30, filt=args[4], with_stats=True, **knobs)
        for got in (eager, captured):
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
def test_cuda_graph_unit_rows_match_plain_traversal_and_capture():
    """Unit rows at 20,000 x 300: on one adjacency, the traversal on K3
    gives the ids of the same traversal with K3's plain version (f32 sums in
    another order: a divergence may only come from a near tie, none here);
    the captured traversal equals the eager one bit for bit and replays
    without new captures; the facade's search is that traversal; its
    entries go when the index is freed."""
    import types

    from repro_torch.core import graph
    from repro_torch.core.types import GraphConfig

    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.nn.functional.normalize(torch.randn((20_000, 300), generator=g, device=dev), dim=1)
    q = torch.nn.functional.normalize(
        x[:64] + 0.05 * torch.randn((64, 300), generator=g, device=dev), dim=1)
    cfg = GraphConfig()
    idx = AnnIndex.build(x, cfg, normalized=True, device=dev)
    gi = idx.index
    knobs = dict(ef=cfg.ef, beam=cfg.beam, iters=cfg.search_iters, n_docs=20_000)
    eager = graph._traverse(gi.vectors, gi.neighbors, gi.entry, q, None, depth=100, **knobs)
    plain_ops = types.SimpleNamespace(
        cosine_topk=graph.fused.cosine_topk,
        fused_topk_gathered=lambda q, store, row_ids, depth, n_docs: ref.gathered_topk_ref(
            q, ref.gather_rows(store, row_ids, n_docs), row_ids, depth, n_docs))
    kept, graph.fused = graph.fused, plain_ops
    try:
        plain = graph._traverse(gi.vectors, gi.neighbors, gi.entry, q, None, depth=100, **knobs)
    finally:
        graph.fused = kept
    assert torch.equal(eager[1], plain[1])
    torch.testing.assert_close(eager[0], plain[0], rtol=1e-5, atol=1e-5)
    graph.TRAVERSAL_CACHE.clear()
    for _ in range(3):
        captured = graph.search_graph(gi.vectors, gi.neighbors, gi.entry, q, 100, **knobs)
        assert torch.equal(captured[0], eager[0]) and torch.equal(captured[1], eager[1])
    stats = graph.TRAVERSAL_CACHE.stats()
    assert stats["compiles"] == 1 and stats["hits"] == 2, stats
    s, i = idx.search(q, k=100, depth=100)  # normalises q once more
    want = graph.search_graph(gi.vectors, gi.neighbors, gi.entry, bruteforce.l2_normalize(q),
                              100, **knobs)
    assert torch.equal(s, want[0]) and torch.equal(i, want[1])
    del idx, gi
    import gc
    gc.collect()
    assert graph.TRAVERSAL_CACHE.stats()["entries"] == 0  # freed with the adjacency


@pytest.mark.gpu
def test_cuda_graph_save_and_load(tmp_path):
    """A graph index built on the card, saved, loaded on the card and on
    the CPU: searches bit-equal on the card, ids equal on the CPU route."""
    from repro_torch.core.types import GraphConfig

    dev = cuda_device()
    x = np.random.default_rng(7).normal(size=(5000, 64)).astype(np.float32)
    idx = AnnIndex.build(x, GraphConfig(ef=48), rerank_store="int8", device=dev)
    q = x[:16] + 0.01
    want = idx.search(q, k=10, depth=50, rerank=True)
    path = str(tmp_path / "graph.ann")
    idx.save(path)
    back = AnnIndex.load(path, device=dev)
    got = back.search(q, k=10, depth=50, rerank=True)
    assert back.method == "hnsw" and back.quantized_rerank
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    cpu = AnnIndex.load(path, device="cpu")
    assert torch.equal(cpu.index.neighbors, idx.index.neighbors.cpu())
    assert_topk_match(cpu.search(q, k=10, depth=50), tuple(
        t.cpu() for t in idx.search(q, k=10, depth=50)), exact=False)


# --------------------------------------------------------------------------
# Serving on the card
# --------------------------------------------------------------------------

SERVED_METHODS = {  # config, match scores bit-equal across batch splits
    "classic": (FakeWordsConfig(quantization=50), True),
    "dot": (FakeWordsConfig(quantization=50, scoring="dot"), True),
    "lsh": (LexicalLshConfig(buckets=64, hashes=2), True),
    "kdtree-scan": (KdTreeConfig(dims=8), False),
    "bruteforce": (BruteForceConfig(), False),
    "hnsw": (GraphConfig(), False),
}


@pytest.mark.gpu
@pytest.mark.parametrize("method", list(SERVED_METHODS))
def test_cuda_service_matches_facade(method):
    """The service on the card (batches padded to 8 with zero rows) against
    the facade's unsplit batch of 24: match-only results of the integer
    modes and classic bit for bit, the f32 modes and every reranked result
    under the near-tie rule; a single query padded with 7 zero rows returns
    the facade's row, and an all-zero batch comes back finite."""
    from repro_torch.serve.ann_service import AnnService, AnnServiceConfig

    dev = cuda_device()
    cfg, exact = SERVED_METHODS[method]
    x = np.random.default_rng(8).normal(size=(4096, 64)).astype(np.float32)
    ann = AnnIndex.build(x, cfg, device=dev)
    qs = x[:24] + 0.01
    for rerank in (False, True):
        svc = AnnService(ann, AnnServiceConfig(k=10, depth=100, rerank=rerank, max_batch=8))
        for q in (qs, qs[:1]):
            want = tuple(t.cpu() for t in ann.search(q, k=10, depth=100, rerank=rerank))
            assert_topk_match(svc.search_batch(q), want, exact=exact and not rerank)
        s0, i0 = svc.search_batch(np.zeros((8, 64), np.float32))
        assert np.isfinite(s0).all() and ((i0 >= 0) & (i0 < 4096)).all()


@pytest.mark.gpu
def test_cuda_async_matches_sync():
    """Singles coalesced by the worker on the card equal the sync service's
    rows bit for bit (classic, match only; every batch padded to 8)."""
    from repro_torch.serve.ann_service import AnnService, AnnServiceConfig

    dev = cuda_device()
    x = np.random.default_rng(10).normal(size=(4096, 64)).astype(np.float32)
    ann = AnnIndex.build(x, FakeWordsConfig(quantization=50), device=dev)
    svc = AnnService(ann, AnnServiceConfig(k=10, depth=100, rerank=False, max_batch=8,
                                           max_wait_s=0.05))
    qs = x[:24] + 0.01
    s_ref, i_ref = svc.search_batch(qs)
    svc.start_async()
    out = [f.result(timeout=60) for f in [svc.search_async(qs[i]) for i in range(24)]]
    svc.stop_async()
    np.testing.assert_array_equal(i_ref, np.concatenate([o[1] for o in out]))
    np.testing.assert_array_equal(s_ref, np.concatenate([o[0] for o in out]))
    assert 1 <= svc.stats()["async_launches"] < 24


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["lsh", "classic"])
def test_cuda_capture_while_another_thread_adds(method, monkeypatch):
    """The async worker's first packed search captures a CUDA graph; a hook
    in the kernel wrapper holds it mid-capture while this thread runs
    ``IndexWriter.add`` (a pageable copy to the card) and ``delete`` and
    device work of its own.  All of it goes through: this thread's stream
    is not capturing, the added rows reach the card intact (a recorded copy
    would not have run), the capture completes, and the captured search
    equals the per-segment loop; after ``refresh`` the added rows are found
    and the deleted ones never come back."""
    import threading

    from repro_torch.core import packed as packed_mod
    from repro_torch.core.segments import IndexWriter
    from repro_torch.kernels.fused_topk import ops
    from repro_torch.serve.ann_service import AnnService, AnnServiceConfig

    dev = cuda_device()
    rng = np.random.default_rng(9)
    cfg = SERVED_METHODS[method][0]
    w = IndexWriter(cfg, merge_policy=None, device=dev)
    x0 = rng.normal(size=(5000, 32)).astype(np.float32)
    w.add(x0)
    svc = AnnService(writer=w, service=AnnServiceConfig(k=10, depth=50, rerank=True,
                                                        max_batch=8, max_wait_s=0.01))
    capturing, added = threading.Event(), threading.Event()
    real = ops.fused_topk

    def held_mid_capture(*args, **kwargs):
        if torch.cuda.is_current_stream_capturing() and not capturing.is_set():
            capturing.set()
            assert added.wait(60)
        return real(*args, **kwargs)

    monkeypatch.setattr(ops, "fused_topk", held_mid_capture)
    packed_mod.EXEC_CACHE.clear()
    q = rng.normal(size=(3, 32)).astype(np.float32)
    svc.start_async()
    futs = [svc.search_async(q)]
    assert capturing.wait(60)
    assert not torch.cuda.is_current_stream_capturing()
    rows = rng.normal(size=(64, 32)).astype(np.float32)
    ids = w.add(rows)
    newly = w.delete([0, 1, 2, 3])
    on_card = w._buf[-1].cpu().numpy()
    total = float(torch.as_tensor(rows, device=dev).double().sum().item())
    added.set()
    s, i = futs[0].result(timeout=60)
    svc.stop_async()
    np.testing.assert_array_equal(on_card, rows)
    assert newly == 4 and abs(total - float(rows.astype(np.float64).sum())) < 1e-9
    assert packed_mod.EXEC_CACHE.compiles == 1
    reader = svc.ann
    loop = tuple(t.cpu() for t in reader.search(q, k=10, depth=50, rerank=True, packed=False))
    assert_topk_match((s, i), loop, exact=False)
    s2, i2 = svc.search_batch(q)  # the captured graph, replayed
    assert packed_mod.EXEC_CACHE.hits >= 1
    np.testing.assert_array_equal(i, i2)
    np.testing.assert_array_equal(s, s2)
    svc.refresh()
    _, found = svc.search_batch(rows[:8])
    np.testing.assert_array_equal(found[:, 0], ids[:8])
    _, gone = svc.search_batch(x0[:4])
    assert not np.isin(gone, [0, 1, 2, 3]).any()


@pytest.mark.gpu
def test_cuda_cache_keys_over_uint32_signatures():
    """The LSH service on the card keys its cache on uint32 MinHash
    signatures (hashed through their int32 bits after a copy to the host):
    the card's key equals the key of the same signatures on the CPU, a
    repeated batch hits and returns the same bits, another batch misses."""
    from repro_torch.serve.ann_service import AnnService, AnnServiceConfig

    dev = cuda_device()
    x = np.random.default_rng(11).normal(size=(4096, 64)).astype(np.float32)
    ann = AnnIndex.build(x, LexicalLshConfig(buckets=64, hashes=2), device=dev)
    svc = AnnService(ann, AnnServiceConfig(k=10, depth=100, rerank=True, max_batch=8,
                                           cache_size=4))
    q = bruteforce.l2_normalize(torch.as_tensor(x[:8], device=dev))
    sig = ann.pipeline.encoder(ann.index, q)
    assert sig.dtype == torch.uint32 and sig.is_cuda
    assert svc._cache_key(sig, q) == svc._cache_key(sig.cpu(), q.cpu())
    a = svc.search_batch(x[:8])
    b = svc.search_batch(x[:8])
    svc.search_batch(x[8:16])
    assert (svc.cache_hits, svc.cache_misses) == (1, 2)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["classic", "hnsw"])
def test_cuda_one_graph_replayed_from_two_threads(method, monkeypatch):
    """Two services over one snapshot share its captured CUDA graph (the
    packed search, the graph traversal).  Searched from two threads at
    once, each with its own queries, every result equals that thread's
    single-threaded result bit for bit: a replay's inputs, run and
    outputs are not interleaved with the other thread's."""
    import threading

    from repro_torch.core.segments import IndexWriter
    from repro_torch.serve.ann_service import AnnService, AnnServiceConfig

    dev = cuda_device()
    rng = np.random.default_rng(23)
    cfg = SERVED_METHODS[method][0]
    x = rng.normal(size=(6000, 32)).astype(np.float32)
    if method == "hnsw":
        ann = AnnIndex.build(x, cfg, device=dev)
    else:
        w = IndexWriter(cfg, merge_policy=None, device=dev)
        for part in np.split(x, 3):
            w.add(part)
            w.flush()
        ann = w.refresh()
    scfg = AnnServiceConfig(k=10, depth=50, rerank=True, max_batch=8)
    svcs = [AnnService(ann, scfg), AnnService(ann, scfg)]
    qs = [rng.normal(size=(8, 32)).astype(np.float32) for _ in svcs]
    alone = [svc.search_batch(q) for svc, q in zip(svcs, qs)]
    replays = _replays(monkeypatch)
    start, bad = threading.Barrier(2), []

    def hammer(j):
        start.wait()
        for _ in range(40):
            s, i = svcs[j].search_batch(qs[j])
            if not (np.array_equal(s, alone[j][0]) and np.array_equal(i, alone[j][1])):
                bad.append(j)

    threads = [threading.Thread(target=hammer, args=(j,)) for j in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert replays[0] >= 80 and not bad


# -- the sharded build and search over a single-process mesh ----------------


SHARDED_METHODS = {
    "classic": FakeWordsConfig(quantization=30),
    "dot": FakeWordsConfig(quantization=30, scoring="dot"),
    "lsh": LexicalLshConfig(buckets=300, hashes=1),
}


def _sharded_rows(n=20_480, dim=300, seed=7):
    """Random rows; a corpus (n >= 1,024) repeats its first 64 rows in
    another shard: exact ties across shards."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    if n >= 1024:
        x[n // 2:n // 2 + 64] = x[:64]
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("method", list(SHARDED_METHODS))
def test_cuda_sharded_match_only_equals_monolithic(method):
    """4 shards on the card (4 x cuda:0 on one card): the build's leaves
    equal the monolithic build's bit for bit, and match-only search returns
    its ids and scores bit for bit at B = 1, 8 and 64."""
    from repro_torch.core import distributed

    dev = cuda_device()
    cfg = SHARDED_METHODS[method]
    x = _sharded_rows()
    mesh = distributed.make_mesh((4,), ("data",))
    assert all(d.type == "cuda" for d in mesh.devices)
    mono = AnnIndex.build(x, cfg, device=dev)
    sh = AnnIndex.build(x, cfg, mesh=mesh)
    g = distributed.gather(sh.index, dev)
    for f in dataclasses.fields(mono.index):
        want = getattr(mono.index, f.name)
        if isinstance(want, torch.Tensor):
            assert torch.equal(getattr(g, f.name), want), f.name
    q = torch.from_numpy(_sharded_rows(64, 300, 8)).to(dev)
    q[:4] = torch.from_numpy(x[:4]).to(dev)
    for b in (1, 8, 64):
        want = mono.search(q[:b], k=10, depth=100)
        got = sh.search(q[:b], k=10, depth=100)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]), b


@pytest.mark.gpu
def test_cuda_ring_graph_build_equals_build_graph():
    """The ring build on 4 x cuda:0 (each pool step on K1 f32) gives
    ``build_graph``'s adjacency and entry points."""
    from repro_torch.core import distributed, graph

    dev = cuda_device()
    x = bruteforce.l2_normalize(torch.from_numpy(_sharded_rows(8192, 64)).to(dev))
    cfg = GraphConfig()
    nb, entry = graph.build_graph(x, cfg)
    mesh = distributed.make_mesh((4,), ("data",))
    nbs, entries = graph.build_graph_sharded(distributed.shard_rows(mesh, x, ("data",)), cfg,
                                             ("data",), x.shape[0])
    assert torch.equal(torch.cat(nbs), nb) and torch.equal(entries[0], entry)


@pytest.mark.gpu
def test_cuda_service_over_mesh_equals_make_sharded_search():
    from repro_torch.core import distributed
    from repro_torch.serve.ann_service import AnnService, AnnServiceConfig

    dev = cuda_device()
    cfg = SHARDED_METHODS["classic"]
    x = _sharded_rows()
    mesh = distributed.make_mesh((4,), ("data",))
    ann = AnnIndex.build(x, cfg, mesh=mesh)
    qs = _sharded_rows(96, 300, 9)
    svc = AnnService(ann, AnnServiceConfig(k=10, depth=100, max_batch=32), mesh=mesh)
    fn = distributed.make_sharded_search(mesh, cfg, ("data",), k=10, depth=100, rerank=True)
    qn = bruteforce.l2_normalize(torch.from_numpy(qs).to(dev))
    got = svc.search_batch(qs)
    for i in range(0, 96, 32):
        s, ids = fn(ann.index, ann.encode_queries(qs[i:i + 32]), qn[i:i + 32])
        assert np.array_equal(got[1][i:i + 32], ids.cpu().numpy())
        assert np.array_equal(got[0][i:i + 32], s.cpu().numpy())


@pytest.mark.gpu
def test_cuda_mesh_over_every_card():
    """With more than one card, ``make_mesh`` puts one shard a card (round
    robin) and the sharded search equals the monolithic one."""
    from repro_torch.core import distributed

    cuda_device()
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip("needs more than one card")
    mesh = distributed.make_mesh((n_cards,), ("data",))
    assert [d.index for d in mesh.devices] == list(range(n_cards))
    cfg = SHARDED_METHODS["classic"]
    x = _sharded_rows(4096 * n_cards)
    mono = AnnIndex.build(x, cfg, device="cuda:0")
    sh = AnnIndex.build(x, cfg, mesh=mesh)
    assert [s.device.index for s in sh.index.shards] == list(range(n_cards))
    q = torch.from_numpy(_sharded_rows(16, 300, 8)).to("cuda:0")
    want, got = mono.search(q, k=10, depth=100), sh.search(q, k=10, depth=100)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    s1, i1 = mono.search(q, k=10, depth=100, rerank=True)
    s2, i2 = sh.search(q, k=10, depth=100, rerank=True)
    assert float(ev.overlap(i1, i2)) > 0.95


# -- the LM and its decode engine -----------------------------------------------


def _lm_on(cfg, dev):
    """The same seeded weights on the CPU and on ``dev``."""
    from repro_torch.models import transformer as tfm

    cpu = tfm.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    return cpu, tfm.tree_map(lambda _, x: x.to(dev), cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["micro-lm", "tiny-lm"])
def test_cuda_engine_tokens_equal_the_cpu_route_f32(arch):
    """micro-lm (dh 32) and tiny-lm (dh 64) in f32: the engine on the card
    (K9 f32, split TF32, in every prefill layer) gives the CPU route's
    tokens on the same weights, 5 requests through 2 slots; and each
    prefill launches K9 once a layer."""
    import dataclasses as dc

    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.launch import train
    from repro_torch.serve.engine import DecodeEngine, EngineConfig, Request

    dev = cuda_device()
    cfg = dc.replace(train.get_model(arch), dtype=torch.float32)
    cpu, card = _lm_on(cfg, dev)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, cfg.vocab, n).astype(np.int32) for n in (7, 19, 7, 12, 30)]
    out = {}
    for name, params, where in (("cpu", cpu, "cpu"), ("cuda", card, dev)):
        eng = DecodeEngine(params, cfg, EngineConfig(batch_slots=2, max_len=64, eos_id=0),
                           device=where)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        before = flash_attention.launches
        eng.run(max_steps=100)
        launched = flash_attention.launches - before
        assert launched == (0 if name == "cpu" else cfg.n_layers * len(prompts)), launched
        out[name] = [r.out_tokens for r in reqs]
    assert out["cuda"] == out["cpu"]


@pytest.mark.gpu
def test_cuda_prefill_counts_one_k9_launch_a_layer_and_refuses_dh16():
    """``prefill`` on the card: ``flash_attention.launches`` rises by the
    layer count; a head dim K9 lacks (16) raises, with no fallback."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.launch import train
    from repro_torch.models import transformer as tfm

    dev = cuda_device()
    cfg = train.get_model("micro-lm")
    _, params = _lm_on(cfg, dev)
    toks = torch.randint(0, cfg.vocab, (2, 40), device=dev)
    before = flash_attention.launches
    cache, logits = tfm.prefill(params, toks, cfg)
    assert flash_attention.launches - before == cfg.n_layers
    assert logits.shape == (2, cfg.vocab) and bool(torch.isfinite(logits).all())
    narrow = tfm.TransformerConfig(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
                                   head_dim=16, d_ff=64, vocab=64)
    _, nparams = _lm_on(narrow, dev)
    with pytest.raises(ValueError, match="head dim 16"):
        tfm.forward(nparams, toks % 64, narrow)


# -- training: K9's backward and a step of the LM --------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,b,hq,hkv,s,d", BWD_CUDA_DTYPE_CASES)
def test_cuda_attention_backward_matches_plain_and_repeats(dtype, b, hq, hkv, s, d):
    """K9's forward with lse (its output bit-equal to the plain entry's, lse
    within 2e-5 of the plain logsumexp) and its backward against
    ``attention_bwd_ref`` on the kernel's own out and lse: K9's row rules
    (bf16 1e-2, f32 1e-4; dq's row 0, zero in exact arithmetic, at its
    head's scale); two launches bit-equal.  ``torch_parity.BWD_CUDA_CASES``,
    in both dtypes, take every kind of split of a GQA group that
    ``kernel.bwd_plan`` makes on a 132-SM card, and an S off the 64-row
    tiles at every head width.  In f32 these hold dq within the rule of its
    tensor's scale, and ``BWD_CUDA_F32_ROW_CASES`` hold it by rows: dq's
    first rows are small differences of near-equal terms, which f32
    rounding moves by a large part of their own norm, the plain backward's
    too (tests/test_torch_flash_attention.py::
    test_plain_f32_backward_misses_dq_rows_against_jax)."""
    from repro_torch.kernels.flash_attention import kernel, ref

    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(s + d)
    q, k, v, dout = (torch.randn(shape, generator=g, device=dev).to(dtype)
                     for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d), (b, hq, s, d)))
    before = (kernel.flash_attention_fwd.launches, kernel.flash_attention_bwd.launches)
    out, lse = kernel.flash_attention_fwd(q, k, v)
    assert torch.equal(out, kernel.flash_attention(q, k, v))
    _, want_lse = ref.attention_fwd_ref(q, k, v)
    assert float(((lse - want_lse).abs() / (1 + want_lse.abs())).max()) <= 2e-5
    got = kernel.flash_attention_bwd(q, k, v, out, lse, dout)
    again = kernel.flash_attention_bwd(q, k, v, out, lse, dout)
    assert (kernel.flash_attention_fwd.launches - before[0],
            kernel.flash_attention_bwd.launches - before[1]) == (1, 2)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    assert [x.dtype for x in got] == [dtype] * 3
    want = ref.attention_bwd_ref(q, k, v, out, lse, dout)
    dq_rows = dtype == torch.bfloat16 or (b, hq, hkv, s, d) in BWD_CUDA_F32_ROW_CASES
    assert_attention_grads_close(got, want, 1e-2 if dtype == torch.bfloat16 else 1e-4,
                                 dq_rows=dq_rows)


@pytest.mark.gpu
def test_cuda_attention_backward_refuses_what_the_kernel_does_not_take():
    from repro_torch.kernels.flash_attention import kernel

    dev = cuda_device()
    x = torch.zeros((1, 2, 8, 16), device=dev)
    lse = torch.zeros((1, 2, 8), device=dev)
    with pytest.raises(ValueError, match="head dim 16"):
        kernel.flash_attention_bwd(x, x, x, x, lse, x)
    y = torch.zeros((1, 2, 8, 32), device=dev)
    with pytest.raises(TypeError):
        kernel.flash_attention_bwd(y, y, y, y.bfloat16(), lse, y)
    with pytest.raises(TypeError):
        kernel.flash_attention_bwd(y, y, y, y, lse.double(), y)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_micro_lm_training_step_matches_cpu_route(dtype):
    """micro-lm (dh 32) on the card against the CPU route from the same
    weights and batch: every leaf's gradient of ``loss_fn`` (relative to
    its scale: f32 1e-4, K9 f32 and the f32 backward against the plain
    versions; bf16 4e-2, tests/test_torch_lm_grad.py's bf16 tolerance), then
    one AdamW step in 2 microbatches: its loss, its gradient norm and the
    parameters after the update.  K9's forward with lse runs twice a layer
    a microbatch (the checkpointed layers' recompute), its backward once."""
    import dataclasses as dc

    from torch_parity import assert_logits_close

    from repro_torch.data import lm as lm_data
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.launch import train
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_loop import build_train_step, make_train_state

    dev = cuda_device()
    cfg = dc.replace(train.get_model("micro-lm"), dtype=dtype)
    cpu, card = _lm_on(cfg, dev)
    batch = lm_data.batch_at(lm_data.LmDataConfig(vocab=cfg.vocab, seq_len=96, global_batch=4,
                                                  seed=5), 0)
    tol = 1e-4 if dtype == torch.float32 else 4e-2
    grads, results = {}, {}
    for name, params, where in (("cpu", cpu, "cpu"), ("cuda", card, dev)):
        leaves = []
        tfm.tree_map(lambda n, x: leaves.append((n, x.requires_grad_())), params)
        loss = tfm.loss_fn(params, batch["tokens"].to(where), batch["labels"].to(where), cfg)
        grads[name] = dict(zip([n for n, _ in leaves],
                               torch.autograd.grad(loss, [x for _, x in leaves])))
        opt = opt_mod.adamw(lr=1e-3)
        state = make_train_state(params, opt)
        step = build_train_step(lambda p, b: tfm.loss_fn(p, b["tokens"], b["labels"], cfg), opt, 2)
        before = (kernel.flash_attention_fwd.launches, kernel.flash_attention_bwd.launches)
        state, m = step(state, {k: x.to(where) for k, x in batch.items()})
        launched = (kernel.flash_attention_fwd.launches - before[0],
                    kernel.flash_attention_bwd.launches - before[1])
        want = (0, 0) if name == "cpu" else (2 * 2 * cfg.n_layers, 2 * cfg.n_layers)
        assert launched == want, (name, launched)
        flat = []
        tfm.tree_map(lambda n, x: flat.append((n, x)), state.params)
        results[name] = (float(m["loss"]), float(m["grad_norm"]), dict(flat))
    for n, g in grads["cpu"].items():
        assert_logits_close(grads["cuda"][n], g, tol, f"gradient of {n}")
    (lc, nc, pc), (lg, ng, pg) = results["cpu"], results["cuda"]
    assert abs(lg - lc) <= tol * abs(lc) and abs(ng - nc) <= tol * nc, (lc, lg, nc, ng)
    for n, x in pc.items():
        assert_logits_close(pg[n], x, tol, f"{n} after the step")


def _model_grads(loss_fn, params):
    """(loss, {leaf name: gradient}) on detached copies of ``params``' leaves
    (a leaf the loss does not use: zeros)."""
    from repro_torch.models.params import tree_map

    fresh = {}

    def leaf(name, v):
        fresh[name] = v.detach().clone().requires_grad_()
        return fresh[name]

    loss = loss_fn(tree_map(leaf, params))
    grads = torch.autograd.grad(loss, list(fresh.values()), allow_unused=True)
    return float(loss.detach()), {n: torch.zeros_like(v) if g is None else g
                                  for (n, v), g in zip(fresh.items(), grads)}


def _hold_model_routes(fwd, loss_fn, params_cpu, dev, x, y):
    """Logits (1e-5 of their scale), loss and every gradient (1e-4) of the
    card against the CPU route from the same parameters and inputs."""
    from torch_parity import assert_logits_close

    from repro_torch.models.params import tree_map

    card = tree_map(lambda _, v: v.to(dev), params_cpu)
    xd = [None if t is None else t.to(dev) for t in x]
    yd = [t.to(dev) for t in y]
    with torch.no_grad():
        assert_logits_close(fwd(card, *xd).cpu(), fwd(params_cpu, *x), 1e-5)
    lc, gc_ = _model_grads(lambda p: loss_fn(p, *xd, *yd), card)
    lp, gp = _model_grads(lambda p: loss_fn(p, *x, *y), params_cpu)
    assert abs(lc - lp) <= 1e-5 * abs(lp), (lc, lp)
    for n, g in gp.items():
        if not g.any():
            assert not gc_[n].any(), n
            continue
        assert_logits_close(gc_[n].cpu(), g, 1e-4, f"gradient of {n}")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["fm", "deepfm", "dlrm-rm2", "xdeepfm"])
def test_cuda_recsys_tower_matches_cpu_route(arch):
    """Each tower at its published widths over a 65,536-row table: logits,
    loss and gradients on the card against the CPU route; the user tower
    and ``retrieval_topk`` (near-tie rule) too."""
    from repro_torch import configs
    from repro_torch.data import recsys as rec_data
    from repro_torch.models import recsys as rec
    from repro_torch.models.params import tree_map

    dev = cuda_device()
    full = configs.get(arch).make_model(None)
    cfg = dataclasses.replace(full, table=rec.TableSpec(
        rec.criteo_row_counts(full.n_fields, 1 << 16), full.dim))
    params = rec.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = rec_data.batch_at(rec_data.RecsysDataConfig(table=cfg.table, batch=256,
                                                    n_dense=cfg.n_dense, seed=2), 0, device="cpu")
    x = (b["sparse"], b.get("dense"))
    _hold_model_routes(lambda p, sp, de: rec.forward(p, cfg, sp, de),
                       lambda p, sp, de, lab: rec.bce_loss(p, cfg, sp, lab, de), params, dev, x,
                       (b["label"],))
    card = tree_map(lambda _, v: v.to(dev), params)
    with torch.no_grad():
        u = rec.user_tower(params, cfg, *x)
        u_card = rec.user_tower(card, cfg, *(None if t is None else t.to(dev) for t in x))
    torch.testing.assert_close(u_card.cpu(), u, rtol=1e-5, atol=1e-6)
    cand = params["table"][: cfg.table.row_counts[0]]
    got = rec.retrieval_topk(u.to(dev), cand.to(dev), 50)
    assert_topk_match([t.cpu() for t in got], rec.retrieval_topk(u, cand, 51), exact=False)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["full_graph_sm", "minibatch_lg", "molecule"])
def test_cuda_graphsage_matches_cpu_route(cell):
    """Each GraphSAGE path (full graph with its embeddings, sampled, batched
    graphs) at the cell's widths on a small graph: the card against the
    CPU route from the same parameters and inputs; the sampler on the card
    keeps its invariants."""
    from repro_torch import configs
    from repro_torch.data import graph as gdata
    from repro_torch.models import gnn

    dev = cuda_device()
    spec = configs.get("graphsage-reddit")
    c = spec.cell(cell)
    cfg = spec.make_model(c)
    params = gnn.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    if cell == "molecule":
        mb = gdata.make_molecule_batch(gen, 16, c.get("n_nodes"), c.get("n_edges"),
                                       c.get("d_feat"), c.get("n_classes"))
        x, y = (mb["feats"], mb["src"], mb["dst"]), (mb["labels"],)
        fwd, loss = gnn.forward_batched, gnn.loss_batched
    else:
        g = gdata.make_graph(gdata.GraphConfig(n_nodes=2000, n_edges=20_000,
                                               d_feat=c.get("d_feat"),
                                               n_classes=c.get("n_classes")), device="cpu")
        if cell == "full_graph_sm":
            x = (g.feats, *g.edge_list())
            y = (g.labels, (torch.arange(2000) % 4 != 0).float())
            fwd, loss = gnn.forward_full, gnn.loss_full
        else:
            seeds = gdata.batch_seeds(gen, 2000, 64)
            n1, n2 = gdata.sample_two_hop(gen, g.indptr, g.indices, seeds, cfg.fanouts)
            x, y = (g.feats, seeds, n1, n2), (g.labels[seeds.long()],)
            fwd, loss = gnn.forward_sampled, gnn.loss_sampled
            gd = gdata.make_graph(gdata.GraphConfig(n_nodes=2000, n_edges=20_000, d_feat=4),
                                  device=dev)
            gen_d = torch.Generator(device=dev).manual_seed(3)
            s_d = gdata.batch_seeds(gen_d, 2000, 512)
            a, b = gdata.sample_two_hop(gen_d, gd.indptr, gd.indices, s_d, cfg.fanouts)
            deg = (gd.indptr[1:] - gd.indptr[:-1])[s_d.long()]
            assert torch.equal((a < 0).any(-1), deg == 0)
            assert bool(((b >= -1) & (b < 2000)).all()) and bool((b[a < 0] == -1).all())
    _hold_model_routes(lambda p, *t: fwd(p, *t, cfg), lambda p, *t: loss(p, *t, cfg), params,
                       dev, x, y)
    if cell == "full_graph_sm":
        from repro_torch.models.params import tree_map

        card = tree_map(lambda _, v: v.to(dev), params)
        with torch.no_grad():
            e_card = gnn.embeddings_full(card, *(t.to(dev) for t in x), cfg)
            e_cpu = gnn.embeddings_full(params, *x, cfg)
        torch.testing.assert_close(e_card.cpu(), e_cpu, rtol=1e-5, atol=1e-5)


def _f32_rule(a, b, c):
    """Hold the product ``c`` of f32 ``a`` and ``b`` to f32's rule: within
    2^-20 of sum |a| |b| of each element from the float64 product (16 f32
    ulps of it; a TF32 product, 10 bits, misses it by far)."""
    want = a.double() @ b.double()
    bound = 2.0**-20 * (a.double().abs() @ b.double().abs())
    return bool(((c.double() - want).abs() <= bound).all())


@pytest.mark.gpu
def test_cuda_f32_matmul_full_f32_under_the_new_precision_setting():
    """With ``fp32_precision = "tf32"`` set by the caller, ``f32_matmul``
    keeps f32's rule (a plain product misses it) and leaves the setting
    as it found it."""
    from repro_torch.kernels.common import f32_matmul

    dev = cuda_device()
    matmul = torch.backends.cuda.matmul
    if not hasattr(matmul, "fp32_precision"):
        pytest.skip(f"torch {torch.__version__} has no fp32_precision")
    g = torch.Generator(device=dev).manual_seed(3)
    a, b = (torch.randn(shape, generator=g, device=dev) for shape in ((256, 1024), (1024, 256)))
    prev = matmul.fp32_precision
    try:
        matmul.fp32_precision = "tf32"
        assert not _f32_rule(a, b, a @ b)  # TF32 is on for a plain product
        assert _f32_rule(a, b, f32_matmul(a, b))
        assert matmul.fp32_precision == "tf32"
    finally:
        matmul.fp32_precision = prev


@pytest.mark.gpu
def test_cuda_f32_matmul_in_two_threads_under_tf32():
    """With ``allow_tf32 = True``, two threads' ``f32_matmul`` products all
    keep f32's rule (each thread's restore cannot switch TF32 on under the
    other's product), and the flag is True after."""
    from repro_torch.kernels.common import f32_matmul

    dev = cuda_device()
    matmul = torch.backends.cuda.matmul
    g = torch.Generator(device=dev).manual_seed(4)
    pairs = [tuple(torch.randn(shape, generator=g, device=dev)
                   for shape in ((128, 1024), (1024, 128))) for _ in range(2)]
    results = [[] for _ in pairs]

    def work(i):
        a, b = pairs[i]
        for _ in range(50):
            results[i].append(_f32_rule(a, b, f32_matmul(a, b)))

    prev = matmul.allow_tf32
    try:
        matmul.allow_tf32 = True
        threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert [len(r) for r in results] == [50, 50] and all(all(r) for r in results)
        assert matmul.allow_tf32 is True
    finally:
        matmul.allow_tf32 = prev


@pytest.mark.gpu
def test_cuda_compressed_psum_and_gpipe_match_cpu_route():
    """On 4 x cuda:0: ``compressed_psum`` over two calls bit-equal to the
    same calls on 4 x cpu (elementwise IEEE operations and an integer sum);
    GPipe's tanh stack bit-equal to its layers run one microbatch at a time
    on the card, and within 1e-5 of the CPU route, output and gradients."""
    from repro_torch.core import distributed
    from repro_torch.train import compression, pipeline

    dev = cuda_device()
    gen = torch.Generator().manual_seed(6)

    def trees(scale):
        return [{"w": scale * torch.randn(4, 16, generator=gen),
                 "b": (scale * torch.randn(32, generator=gen)).to(torch.bfloat16)}
                for _ in range(4)]

    calls = [trees(1.0), trees(3.0)]
    out = {}
    for where in ("cpu", dev):
        mesh = distributed.make_mesh((4,), ("data",), device=where)
        r = [compression.init_residual({k: v.to(where) for k, v in t.items()})
             for t in calls[0]]
        got = []
        for grads in calls:
            o, r = compression.compressed_psum(
                [{k: v.to(where) for k, v in t.items()} for t in grads], r, mesh, "data")
            got.append((o, r))
        out[str(where)] = got
    for (oc, rc), (og, rg) in zip(out["cpu"], out[str(dev)]):
        for s in range(4):
            for k in ("w", "b"):
                assert torch.equal(og[s][k].cpu(), oc[s][k]) and torch.equal(rg[s][k].cpu(),
                                                                              rc[s][k])

    ws = (torch.randn(8, 16, 16, generator=gen) / 4).requires_grad_()
    x = torch.randn(4, 2, 16, generator=gen)
    cot = torch.randn(4, 2, 16, generator=gen)
    res = {}
    for where in ("cpu", dev):
        w = ws.detach().to(where).requires_grad_()
        mesh = distributed.make_mesh((4,), ("pipe",), device=where)
        y = pipeline.build_gpipe_fn(mesh, lambda h, layer: torch.tanh(h @ layer), 4)(
            w, x.to(where))
        seq = x.to(where)
        for layer in w.detach().unbind(0):
            seq = torch.tanh(seq @ layer)
        assert torch.equal(y.detach(), seq)
        res[str(where)] = (y.detach(), *torch.autograd.grad(y, w, cot.to(where)))
    for c, g in zip(res["cpu"], res[str(dev)]):
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), atol=1e-5)
