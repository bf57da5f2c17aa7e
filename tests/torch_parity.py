"""Helpers shared by the ``test_torch_*`` files: moving arrays from JAX /
numpy to torch and holding top-k results against each other."""
import numpy as np
import pytest
import torch

# The suite runs several pytest workers on one host, each with JAX's own
# thread pool; torch's default intra-op pool (one thread per core) in every
# worker would oversubscribe the cores.  The port's CPU tests are small.
torch.set_num_threads(1)


def to_torch(a) -> torch.Tensor:
    """numpy or JAX array -> CPU tensor (a copy); bfloat16 through its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def assert_topk_match(got, want, exact: bool, rtol: float = 1e-5, atol: float = 1e-5):
    """Hold (scores, ids) ``got`` against ``want``.  ``want`` may carry one
    rank more than ``got`` so that the last rank's gap is known.  Exact:
    bit-equal.  Else scores within rtol/atol, and ids equal at every rank
    whose wanted score differs from both neighbours by more than that
    tolerance (elsewhere a summation-order difference may swap a near-tie)."""
    gs, gi = (np.asarray(x) for x in got)
    ws, wi = (np.asarray(x) for x in want)
    d = gs.shape[1]
    if exact:
        np.testing.assert_array_equal(gs, ws[:, :d])
        np.testing.assert_array_equal(gi, wi[:, :d])
        return
    np.testing.assert_allclose(gs, ws[:, :d], rtol=rtol, atol=atol)
    with np.errstate(invalid="ignore"):
        big = np.abs(np.diff(ws, axis=1)) > atol + rtol * np.abs(ws[:, 1:])
    pad = np.ones_like(big[:, :1])
    lone = (np.concatenate([pad, big], 1) & np.concatenate([big, pad], 1))[:, :d]
    lone |= ~np.isfinite(ws[:, :d])
    np.testing.assert_array_equal(gi[lone], wi[:, :d][lone])


def cuda_device() -> torch.device:
    """The first CUDA device; skips the calling test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
