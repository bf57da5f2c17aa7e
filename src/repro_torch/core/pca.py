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
distances and the PPA projections do not.  The reference's sharded fit
(``axes`` / ``n_total``) is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.types import _nbytes
from repro_torch.kernels.common import f32_matmul


def _mean_cov(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, covariance) of the rows: the centered Gram matrix over N."""
    mean = x.mean(dim=0)
    xc = x - mean
    return mean, f32_matmul(xc.T, xc) / x.shape[0]


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


def pca_fit(x: torch.Tensor, out_dim: int) -> PcaModel:
    """Fit PCA: the projection onto the top ``out_dim`` components."""
    mean, cov = _mean_cov(x)
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


def ppa_fit(x: torch.Tensor, remove: int) -> PpaModel:
    mean, cov = _mean_cov(x)
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


def ppa_pca_ppa_fit(x: torch.Tensor, out_dim: int, remove: int = 3) -> PpaPcaPpaModel:
    """Raunak (2017): PPA -> PCA(out_dim) -> PPA, fitted stage by stage."""
    ppa1 = ppa_fit(x, remove)
    x1 = ppa_apply(ppa1, x)
    pca = pca_fit(x1, out_dim)
    x2 = pca_apply(pca, x1)
    # The second PPA removes min(remove, out_dim - 1) components of the
    # reduced space.
    r2 = max(1, min(remove, out_dim - 1))
    return PpaPcaPpaModel(ppa1=ppa1, pca=pca, ppa2=ppa_fit(x2, r2))


def ppa_pca_ppa_apply(model: PpaPcaPpaModel, x: torch.Tensor) -> torch.Tensor:
    return ppa_apply(model.ppa2, pca_apply(model.pca, ppa_apply(model.ppa1, x)))


def fit_reduction(x: torch.Tensor, out_dim: int, kind: str, ppa_remove: int = 3):
    """(model, reduced rows) for the k-d tree builder."""
    if kind == "pca":
        model = pca_fit(x, out_dim)
        return model, pca_apply(model, x)
    if kind == "ppa-pca-ppa":
        model = ppa_pca_ppa_fit(x, out_dim, ppa_remove)
        return model, ppa_pca_ppa_apply(model, x)
    raise ValueError(f"unknown reduction kind {kind!r}")


def apply_reduction(model, x: torch.Tensor) -> torch.Tensor:
    if isinstance(model, PcaModel):
        return pca_apply(model, x)
    if isinstance(model, PpaPcaPpaModel):
        return ppa_pca_ppa_apply(model, x)
    raise TypeError(f"unknown reduction model {type(model)}")
