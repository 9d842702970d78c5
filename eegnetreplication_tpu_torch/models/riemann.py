"""Riemannian tangent-space classifier baseline, in torch.

The counterpart of ``eegnetreplication_tpu/models/riemann.py`` (the
reference's pyriemann ``TangentSpace >> LDA`` comparison):

- **trial covariances**, trace-normalized and shrunk toward the scaled
  identity, so every matrix is SPD even for short windows;
- **the Riemannian (Karcher) mean** by the fixed-point iteration ``M <-
  M^{1/2} exp(mean_i log(M^{-1/2} P_i M^{-1/2})) M^{1/2}``, a fixed number
  of times from the arithmetic mean;
- **the tangent-space projection** at the mean: the upper triangle of
  ``log(M^{-1/2} P M^{-1/2})`` with off-diagonal entries scaled by
  sqrt(2), ``C(C+1)/2`` features;
- **LDA** from :mod:`~eegnetreplication_tpu_torch.models.csp`.

Every matrix function is spectral through ``torch.linalg.eigh`` (batched,
on the card when the tensors are there), in f32.  Eigenvectors are the
solver's choice up to sign and order; the matrix functions, features,
scores and predictions are not.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from eegnetreplication_tpu_torch.models.csp import (
    N_CLASSES,
    lda_fit,
    lda_scores,
)

_EIGH_FLOOR = 1e-10


def _spd_fn(mat: torch.Tensor, fn: Callable[[torch.Tensor], torch.Tensor],
            floor: float | None = _EIGH_FLOOR) -> torch.Tensor:
    """A scalar function of a symmetric matrix's spectrum (batched).
    ``floor`` guards sqrt and log against rounding below zero; ``None``
    (for ``exp`` of a tangent matrix, symmetric but indefinite) keeps the
    spectrum as it is."""
    s, u = torch.linalg.eigh(mat)
    if floor is not None:
        s = torch.clamp(s, min=floor)
    return torch.einsum("...ij,...j,...kj->...ik", u, fn(s), u)


def trial_covariances(X: torch.Tensor, shrinkage: float = 0.1
                      ) -> torch.Tensor:
    """Shrunk, trace-normalized spatial covariances ``(N, C, C)``."""
    c, t = X.shape[1], X.shape[2]
    Xc = X - X.mean(dim=2, keepdim=True)
    covs = torch.einsum("nct,ndt->ncd", Xc, Xc) / (t - 1)
    trace = torch.diagonal(covs, dim1=1, dim2=2).sum(-1)
    covs = covs / (trace[:, None, None] + 1e-12)
    mu = torch.diagonal(covs, dim1=1, dim2=2).sum(-1)[:, None, None] / c
    eye = torch.eye(c, dtype=X.dtype, device=X.device)
    return (1.0 - shrinkage) * covs + shrinkage * mu * eye


def riemannian_mean(covs: torch.Tensor, n_iter: int = 10) -> torch.Tensor:
    """Karcher mean ``(C, C)`` of SPD matrices ``(N, C, C)``: ``n_iter``
    fixed-point steps from the arithmetic mean."""
    m = covs.mean(dim=0)
    for _ in range(n_iter):
        m_isqrt = _spd_fn(m, lambda s: 1.0 / torch.sqrt(s))
        m_sqrt = _spd_fn(m, torch.sqrt)
        whitened = torch.einsum("ij,njk,kl->nil", m_isqrt, covs, m_isqrt)
        tangent = _spd_fn(whitened, torch.log).mean(dim=0)
        m = m_sqrt @ _spd_fn(tangent, torch.exp, floor=None) @ m_sqrt
    return m


def tangent_features(covs: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """Covariances projected to the tangent space at ``mean``: ``(N,
    C(C+1)/2)``, pyriemann's vectorization (upper triangle, off-diagonal
    entries times sqrt(2))."""
    c = covs.shape[-1]
    m_isqrt = _spd_fn(mean, lambda s: 1.0 / torch.sqrt(s))
    whitened = torch.einsum("ij,njk,kl->nil", m_isqrt, covs, m_isqrt)
    logs = _spd_fn(whitened, torch.log)
    rows, cols = torch.triu_indices(c, c, device=covs.device)
    weights = torch.where(rows == cols, 1.0, math.sqrt(2.0)).to(covs.dtype)
    return logs[:, rows, cols] * weights


def tangent_lda_fit_predict(train_x: torch.Tensor, train_y: torch.Tensor,
                            test_x: torch.Tensor, *,
                            cov_shrinkage: float = 0.1,
                            lda_shrinkage: float = 0.1, mean_iter: int = 10,
                            n_classes: int = N_CLASSES) -> torch.Tensor:
    """Covariances -> Karcher mean of the training trials -> tangent
    features -> shrunk LDA; test predictions ``(N,)``."""
    train_cov = trial_covariances(train_x, cov_shrinkage)
    test_cov = trial_covariances(test_x, cov_shrinkage)
    mean = riemannian_mean(train_cov, mean_iter)
    model = lda_fit(tangent_features(train_cov, mean), train_y,
                    lda_shrinkage, n_classes)
    scores = lda_scores(model, tangent_features(test_cov, mean))
    return torch.argmax(scores, dim=1)


def tangent_lda_accuracy(train_x, train_y, test_x, test_y, *, device=None,
                         **kw) -> float:
    """Test accuracy (%) of the tangent-space+LDA pipeline on arrays or
    tensors, on ``device`` (default: where ``train_x`` is)."""
    args = [torch.as_tensor(a, device=device)
            for a in (train_x, train_y, test_x, test_y)]
    pred = tangent_lda_fit_predict(args[0].float(), args[1],
                                   args[2].float(), **kw)
    return float(100.0 * (pred == args[3].to(pred.device)).float().mean())
