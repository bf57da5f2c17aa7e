"""Dimensionality reduction for the k-d tree path (port of
``repro/core/pca.py``).

The paper reduces 300-d embeddings to <= 8 dims (Lucene's BKD limit) with
either plain PCA (Wold et al. 1987) or the PPA -> PCA -> PPA pipeline of
Raunak (2017), where PPA is the "all-but-the-top" post-processing of Mu et
al. (2017): subtract the mean, remove the projections onto the top-D
principal components.

Every fit is an exact eigendecomposition of the (dim x dim) covariance.
The covariance product and the projections run through
``common.f32_matmul``, so on the card TF32 never enters them.
``torch.linalg.eigh`` returns eigenvalues in ascending order, as
``jnp.linalg.eigh`` does; an eigenvector's sign is not fixed by either, so
raw components may differ in sign from the reference's while the reduced
distances and the PPA projections do not.

Sharded fits (the sharded k-d build, :mod:`repro_torch.core.distributed`):
every fit takes ``axes`` / ``n_total``.  With ``axes`` set, ``x`` is the
list of the shards' row blocks (one tensor a shard, in flat order, each on
its shard's device) and the moments are ``psum``-ed: the mean from the
summed row sums, the covariance from the summed Gram matrices centred on
that global mean.  The model comes out once, on shard 0's device, and the
projected rows as a list again: every shard projects through the same
model while its rows stay where they are.  The sums run in flat order, so
the moments match a monolithic fit up to summation order (and bit for bit
on one shard).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.types import _nbytes
from repro_torch.kernels.common import f32_matmul


def _mean_cov(x, axes: Optional[Sequence[str]] = None,
              n_total: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, covariance) of the rows: the centered Gram matrix over N.
    With ``axes``, of the shards' rows ``x`` (a list) over ``n_total``."""
    if axes is None:
        mean = x.mean(dim=0)
        xc = x - mean
        return mean, f32_matmul(xc.T, xc) / x.shape[0]
    from repro_torch.core import distributed

    if n_total is None:
        raise ValueError("a sharded fit needs the global row count n_total")
    mean = distributed.psum([xs.sum(dim=0) for xs in x]) / n_total
    means = distributed.replicate(mean, [xs.device for xs in x])
    gram = distributed.psum([f32_matmul((xs - m).T, xs - m) for xs, m in zip(x, means)])
    return mean, gram / n_total


def _each(apply, model, x, axes):
    """``apply(model, x)``, or with ``axes`` on every shard's rows through
    the model's copy on that shard's device (one copy a device)."""
    if axes is None:
        return apply(model, x)
    from repro_torch.core import distributed

    return [apply(m, xs) for m, xs in zip(distributed.replicate(model, [xs.device for xs in x]),
                                          x)]


def _top_eigenvectors(cov: torch.Tensor, count: int) -> torch.Tensor:
    """The eigenvectors of the ``count`` largest eigenvalues, largest first
    (eigh's trailing columns in reverse)."""
    _, vecs = torch.linalg.eigh(cov)
    return vecs.flip(-1)[:, :count].contiguous()


@dataclasses.dataclass(frozen=True)
class PcaModel:
    mean: torch.Tensor  # (dim,)
    components: torch.Tensor  # (dim, out_dim), columns = top eigenvectors

    def nbytes(self) -> int:
        return _nbytes(self.mean, self.components)


def pca_fit(x, out_dim: int, axes: Optional[Sequence[str]] = None,
            n_total: Optional[int] = None) -> PcaModel:
    """Fit PCA: the projection onto the top ``out_dim`` components."""
    mean, cov = _mean_cov(x, axes, n_total)
    return PcaModel(mean=mean, components=_top_eigenvectors(cov, out_dim))


def pca_apply(model: PcaModel, x: torch.Tensor) -> torch.Tensor:
    return f32_matmul(x - model.mean, model.components)


@dataclasses.dataclass(frozen=True)
class PpaModel:
    """All-but-the-top (Mu et al.): remove the mean and the top-D components."""

    mean: torch.Tensor  # (dim,)
    top: torch.Tensor  # (dim, D)

    def nbytes(self) -> int:
        return _nbytes(self.mean, self.top)


def ppa_fit(x, remove: int, axes: Optional[Sequence[str]] = None,
            n_total: Optional[int] = None) -> PpaModel:
    mean, cov = _mean_cov(x, axes, n_total)
    return PpaModel(mean=mean, top=_top_eigenvectors(cov, remove))


def ppa_apply(model: PpaModel, x: torch.Tensor) -> torch.Tensor:
    xc = x - model.mean
    return xc - f32_matmul(f32_matmul(xc, model.top), model.top.T)


@dataclasses.dataclass(frozen=True)
class PpaPcaPpaModel:
    ppa1: PpaModel
    pca: PcaModel
    ppa2: PpaModel

    def nbytes(self) -> int:
        return _nbytes(self.ppa1, self.pca, self.ppa2)


def ppa_pca_ppa_fit(x, out_dim: int, remove: int = 3, axes: Optional[Sequence[str]] = None,
                    n_total: Optional[int] = None) -> PpaPcaPpaModel:
    """Raunak (2017): PPA -> PCA(out_dim) -> PPA, fitted stage by stage.
    Sharded, each stage sums its own moments, then applies its (replicated)
    model to the local rows: three fits, six sums, no rows moved."""
    ppa1 = ppa_fit(x, remove, axes, n_total)
    x1 = _each(ppa_apply, ppa1, x, axes)
    pca = pca_fit(x1, out_dim, axes, n_total)
    x2 = _each(pca_apply, pca, x1, axes)
    # The second PPA removes min(remove, out_dim - 1) components of the
    # reduced space.
    r2 = max(1, min(remove, out_dim - 1))
    return PpaPcaPpaModel(ppa1=ppa1, pca=pca, ppa2=ppa_fit(x2, r2, axes, n_total))


def ppa_pca_ppa_apply(model: PpaPcaPpaModel, x: torch.Tensor) -> torch.Tensor:
    return ppa_apply(model.ppa2, pca_apply(model.pca, ppa_apply(model.ppa1, x)))


def fit_reduction(x, out_dim: int, kind: str, ppa_remove: int = 3,
                  axes: Optional[Sequence[str]] = None, n_total: Optional[int] = None):
    """(model, reduced rows) for the k-d tree builder; with ``axes`` the fit
    runs from the shards' summed moments and the reduced rows are a list,
    one a shard."""
    if kind == "pca":
        model = pca_fit(x, out_dim, axes, n_total)
        return model, _each(pca_apply, model, x, axes)
    if kind == "ppa-pca-ppa":
        model = ppa_pca_ppa_fit(x, out_dim, ppa_remove, axes, n_total)
        return model, _each(ppa_pca_ppa_apply, model, x, axes)
    raise ValueError(f"unknown reduction kind {kind!r}")


def apply_reduction(model, x: torch.Tensor) -> torch.Tensor:
    if isinstance(model, PcaModel):
        return pca_apply(model, x)
    if isinstance(model, PpaPcaPpaModel):
        return ppa_pca_ppa_apply(model, x)
    raise TypeError(f"unknown reduction model {type(model)}")
