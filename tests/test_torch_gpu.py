"""The port on a CUDA card: the fused top-k kernels (K1/K2, the gathered K3,
and the quantized K4/K5) against their plain versions, and the searches on
the card (dense, blockmax, lexical LSH, the quantized read path) against the
port's CPU route.  Every test carries the ``gpu`` marker and skips without a
card; this file imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch_parity import assert_topk_match, cuda_device

from repro_torch.core import builder, bruteforce
from repro_torch.core import eval as ev
from repro_torch.core.index import AnnIndex
from repro_torch.core.types import BruteForceConfig, FakeWordsConfig, LexicalLshConfig
from repro_torch.kernels.fused_topk import ref
from repro_torch.kernels.fused_topk.kernel import (
    fused_topk,
    fused_topk_gathered,
    fused_topk_gathered_quantized,
    fused_topk_quantized,
    gathered_plan,
    plan,
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


@pytest.mark.gpu
def test_launch_plan_fills_the_card_at_both_batch_sizes():
    cuda_device()
    n_tiles = -(-2_999_808 // 256)  # 256-doc tiles
    for b, bq_want in ((256, 32), (1, 8)):
        bq, k, splits, per = plan(b, 2_999_808, 100, sm_count=132)
        assert (bq, k) == (bq_want, 128)
        assert -(-b // bq) * splits >= 132
        assert (splits - 1) * per < n_tiles <= splits * per  # no empty split
    assert plan(256, 5000, 1000, 132)[0] == 8  # wide lists: 8-query blocks
    assert plan(1, 5000, 3072, 132)[1] == 3072
    with pytest.raises(ValueError, match="shared memory"):
        plan(1, 5000, 3073, 132)
    # the gathered kernel: B x splits covers the SMs; >= 256 rows a split
    r = 1171 * 256
    for b in (1, 8, 256):
        k, splits, per = gathered_plan(1, b, r, 600, 100, sm_count=132)
        assert k == 128 and per % 32 == 0 and (splits - 1) * per < r <= splits * per
        assert b * splits >= 132 and per >= 256
    with pytest.raises(ValueError, match="shared memory"):
        gathered_plan(1, 1, 10_000, 600, 3700, sm_count=132)


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
