"""Classical CSP + LDA baseline, in torch.

The counterpart of ``eegnetreplication_tpu/models/csp.py``, the classical
motor-imagery pipeline the reference compares EEGNet with (CSP+LDA through
moabb/mne in its notebooks):

- **CSP** (Common Spatial Patterns), one class against the rest: per class
  the filters are the top generalized eigenvectors of ``(Sigma_k,
  Sigma_total)``, found in whitened space with two ``torch.linalg.eigh``
  calls;
- **log-variance features**, ``log(var(w^T x))`` per filter, normalized by
  their sum;
- **LDA** with shrinkage: class means and a shrunk pooled covariance, in
  closed form.

Every function runs where its tensors are (the card when the caller's
trials are there), in f32.  An eigenvector's sign, and the order of equal
eigenvalues, are the solver's choice: the features, scores and
predictions do not depend on them, so those are what match the JAX
package, not the filters.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

N_CLASSES = 4


def _one_hot(y: torch.Tensor, n_classes: int, dtype) -> torch.Tensor:
    return torch.nn.functional.one_hot(y.long(), n_classes).to(dtype)


def _class_covariances(X: torch.Tensor, y: torch.Tensor,
                       n_classes: int = N_CLASSES
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-class mean trial covariance ``(K, C, C)`` and the overall mean;
    each trial's covariance is normalized by its trace."""
    t = X.shape[-1]
    Xc = X - X.mean(dim=2, keepdim=True)
    covs = torch.einsum("nct,ndt->ncd", Xc, Xc) / (t - 1)
    trace = torch.diagonal(covs, dim1=1, dim2=2).sum(-1)
    covs = covs / (trace[:, None, None] + 1e-12)
    onehot = _one_hot(y, n_classes, X.dtype)                   # (N, K)
    counts = onehot.sum(dim=0)
    per_class = torch.einsum("nk,ncd->kcd", onehot, covs) / (
        counts[:, None, None] + 1e-12)
    return per_class, covs.mean(dim=0)


def csp_fit(X: torch.Tensor, y: torch.Tensor, n_components: int = 2,
            n_classes: int = N_CLASSES) -> torch.Tensor:
    """One-against-rest CSP filters ``(n_classes * n_components, C)``: per
    class the eigenvectors of the whitened ``Sigma_k`` with the largest
    eigenvalues, largest first."""
    per_class, total = _class_covariances(X, y, n_classes)
    c = total.shape[0]
    eye = torch.eye(c, dtype=total.dtype, device=total.device)
    s, u = torch.linalg.eigh(total + 1e-10 * eye)
    whiten = (u / torch.sqrt(torch.clamp(s, min=1e-12))).T     # (C, C)
    m = whiten @ per_class @ whiten.T                          # (K, C, C)
    _, v = torch.linalg.eigh((m + m.transpose(1, 2)) / 2)
    top = v[:, :, -n_components:].flip(-1)                     # largest first
    return (top.transpose(1, 2) @ whiten).reshape(-1, c)


def csp_transform(X: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    """Log-variance features ``(N, n_filters)`` of the filtered trials."""
    proj = torch.einsum("fc,nct->nft", filters, X)
    var = proj.var(dim=2, unbiased=False)
    return torch.log(var / (var.sum(dim=1, keepdim=True) + 1e-12) + 1e-12)


@dataclass(frozen=True)
class LDAModel:
    means: torch.Tensor        # (K, F)
    cov_inv: torch.Tensor      # (F, F)
    log_priors: torch.Tensor   # (K,)


def lda_fit(F: torch.Tensor, y: torch.Tensor, shrinkage: float = 0.1,
            n_classes: int = N_CLASSES) -> LDAModel:
    """Closed-form LDA: class means and the pooled covariance shrunk toward
    its mean eigenvalue."""
    onehot = _one_hot(y, n_classes, F.dtype)
    counts = onehot.sum(dim=0)
    means = (onehot.T @ F) / (counts[:, None] + 1e-12)
    centered = F - means[y.long()]
    pooled = (centered.T @ centered) / max(len(F) - n_classes, 1)
    mu = torch.trace(pooled) / pooled.shape[0]
    eye = torch.eye(pooled.shape[0], dtype=F.dtype, device=F.device)
    shrunk = (1 - shrinkage) * pooled + shrinkage * mu * eye
    return LDAModel(means=means, cov_inv=torch.linalg.inv(shrunk),
                    log_priors=torch.log(counts / counts.sum() + 1e-12))


def lda_scores(model: LDAModel, F: torch.Tensor) -> torch.Tensor:
    """Linear discriminant scores ``(N, K)``; the argmax is the
    prediction."""
    wm = model.means @ model.cov_inv                           # (K, F)
    bias = model.log_priors - 0.5 * torch.sum(wm * model.means, dim=1)
    return F @ wm.T + bias


def csp_lda_fit_predict(train_x: torch.Tensor, train_y: torch.Tensor,
                        test_x: torch.Tensor, *, n_components: int = 2,
                        shrinkage: float = 0.1,
                        n_classes: int = N_CLASSES) -> torch.Tensor:
    """The pipeline: CSP and LDA fitted on the training trials, test
    predictions ``(N,)``."""
    filters = csp_fit(train_x, train_y, n_components, n_classes)
    model = lda_fit(csp_transform(train_x, filters), train_y, shrinkage,
                    n_classes)
    return torch.argmax(lda_scores(model, csp_transform(test_x, filters)),
                        dim=1)


def csp_lda_accuracy(train_x, train_y, test_x, test_y, *, device=None,
                     **kw) -> float:
    """Test accuracy (%) of the CSP+LDA pipeline on arrays or tensors, on
    ``device`` (default: where ``train_x`` is, the CPU for arrays)."""
    args = [torch.as_tensor(a, device=device)
            for a in (train_x, train_y, test_x, test_y)]
    pred = csp_lda_fit_predict(args[0].float(), args[1], args[2].float(),
                               **kw)
    return float(100.0 * (pred == args[3].to(pred.device)).float().mean())
