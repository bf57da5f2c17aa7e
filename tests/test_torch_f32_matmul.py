"""``kernels.common.f32_matmul``'s precision switch (``_full_f32``) on the
CPU: it sets cuBLAS's f32 products to full f32 inside, holds its lock over
the switch and the product, and restores the caller's own setting after,
through ``fp32_precision`` where torch has it (reading ``allow_tf32`` raises
once a caller has set that) and through ``allow_tf32`` where it has not.
The products themselves run on the card: ``tests/test_torch_gpu.py``
``-k f32_matmul``."""
import threading
import types

import torch

from repro_torch.kernels import common


def _restoring(fn):
    """Run ``fn`` and put cuBLAS's f32 setting back as it was."""
    matmul = torch.backends.cuda.matmul
    prev = matmul.fp32_precision
    try:
        fn(matmul)
    finally:
        matmul.fp32_precision = prev


def test_full_f32_restores_the_new_precision_setting():
    def check(matmul):
        matmul.fp32_precision = "tf32"
        with common._full_f32():
            assert matmul.fp32_precision == "ieee"
            assert not common._F32_LOCK.acquire(blocking=False)  # held over the product
        assert matmul.fp32_precision == "tf32"
        assert common._F32_LOCK.acquire(blocking=False)
        common._F32_LOCK.release()

    _restoring(check)


def test_f32_matmul_on_the_cpu_reads_no_setting():
    """On the CPU no setting is read: with the new setting at "tf32" a
    read of ``allow_tf32`` would raise."""
    def check(matmul):
        matmul.fp32_precision = "tf32"
        a, b = torch.randn(5, 7), torch.randn(7, 3, dtype=torch.bfloat16)
        assert torch.equal(common.f32_matmul(a, b), a @ b.float())
        assert matmul.fp32_precision == "tf32"

    _restoring(check)


def test_full_f32_restores_the_callers_allow_tf32(monkeypatch):
    """Where torch lacks ``fp32_precision`` the legacy flag is switched, and
    restored to what the caller had, not to a fixed True."""
    for before in (True, False):
        legacy = types.SimpleNamespace(allow_tf32=before)
        monkeypatch.setattr(torch.backends.cuda, "matmul", legacy)
        with common._full_f32():
            assert legacy.allow_tf32 is False
        assert legacy.allow_tf32 is before


def test_full_f32_admits_one_thread_at_a_time():
    inside, order = threading.Event(), []

    def first():
        with common._full_f32():
            inside.set()
            order.append("first in")
            threading.Event().wait(0.2)
            order.append("first out")

    def second():
        inside.wait(10)
        with common._full_f32():
            order.append("second in")

    def check(matmul):
        matmul.fp32_precision = "tf32"
        threads = [threading.Thread(target=f) for f in (first, second)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        assert not any(t.is_alive() for t in threads)
        assert order == ["first in", "first out", "second in"]
        assert matmul.fp32_precision == "tf32"

    _restoring(check)
