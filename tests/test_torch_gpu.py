"""The port on a CUDA card: the fused top-k kernel against its plain
version, and the search on the card against the port's CPU route.  Every
test carries the ``gpu`` marker and skips without a card; this file imports
no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch
from torch_parity import assert_topk_match, cuda_device

from repro_torch.core import eval as ev
from repro_torch.core.index import AnnIndex
from repro_torch.core.types import BruteForceConfig, FakeWordsConfig
from repro_torch.kernels.fused_topk import ref
from repro_torch.kernels.fused_topk.kernel import fused_topk, plan


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
def test_cuda_kernel_matches_plain_version(kind):
    dev = cuda_device()
    b, n, t, depth = (9, 1000, 16, 1000) if kind == "ties" else (37, 3000, 257, 100)
    q, d = _operands(kind, b, n, t, dev)
    mode = "lsh" if kind == "lsh" else "gemm"
    filt = torch.rand((b, n), generator=torch.Generator(device=dev).manual_seed(0),
                      device=dev) < 0.5
    before = fused_topk.launches
    got = fused_topk(q, d, depth, mode=mode, filt=filt)
    torch.cuda.synchronize()
    assert fused_topk.launches == before + 1
    want = ref.fused_topk_ref(q, d, min(depth + 1, n), mode=mode, filt=filt)
    assert_topk_match([x.cpu() for x in got], [x.cpu() for x in want],
                      exact=kind in ("int8", "lsh", "ties"))


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


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["classic", "dot", "bruteforce"])
def test_cuda_search_matches_cpu_port(method):
    cuda_device()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2000, 64)).astype(np.float32)
    q = x[:24] + 0.05 * rng.normal(size=(24, 64)).astype(np.float32)
    cfg = BruteForceConfig() if method == "bruteforce" else FakeWordsConfig(scoring=method)
    cpu = AnnIndex.build(x, cfg, device="cpu")
    gpu = AnnIndex.build(x, cfg)
    assert gpu.device.type == "cuda"
    for rerank in (False, True):
        want = cpu.search(q, k=10, depth=100, rerank=rerank)
        got = gpu.search(q, k=10, depth=100, rerank=rerank)
        assert float(ev.overlap(want[1], got[1].cpu())) >= 0.99
