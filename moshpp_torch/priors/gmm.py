"""Max-mixture GMM pose prior (port of `moshpp_tpu/priors/gmm.py`).

The prior residual for pose x is the Mahalanobis whitening of the single
most-likely mixture component plus a constant sqrt(-log w) row:

  r_k(x) = sqrt(0.5) * (x - mu_k) @ chol(prec_k)
  k*     = argmin_k |r_k|^2 - log w_k
  r(x)   = concat(r_{k*}(x), sqrt(-log w_{k*}))
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MaxMixturePrior:
    means: torch.Tensor           # (K, D)
    chols: torch.Tensor           # (K, D, D) cholesky factors of the precisions
    sqrt_neg_log_w: torch.Tensor  # (K,)


def gmm_prior_from_arrays(means, chols, sqrt_neg_log_w,
                          *, device) -> MaxMixturePrior:
    """Prior on `device` from numpy arrays (e.g. the fields of a JAX
    prior)."""
    t = lambda a: torch.as_tensor(np.array(a, np.float32), device=device)
    return MaxMixturePrior(t(means), t(chols), t(sqrt_neg_log_w))


def select_component(prior: MaxMixturePrior, x: torch.Tensor) -> torch.Tensor:
    """Index (N,) of the least-energy component for poses x (N, D)."""
    diff_all = x[:, None, :] - prior.means                  # (N, K, D)
    r_all = torch.einsum("nkd,kde->nke", diff_all, prior.chols)
    energies = 0.5 * torch.sum(r_all * r_all, dim=-1) + prior.sqrt_neg_log_w ** 2
    return torch.argmin(energies, dim=-1)


def gmm_prior_residual(prior: MaxMixturePrior, x: torch.Tensor) -> torch.Tensor:
    """Residual rows (N, D+1) for pose slices x (N, D)."""
    k = select_component(prior, x)
    r = math.sqrt(0.5) * torch.einsum("nd,nde->ne", x - prior.means[k],
                                      prior.chols[k])
    return torch.cat([r, prior.sqrt_neg_log_w[k][:, None]], dim=-1)


def _from_moments(means: np.ndarray, covars: np.ndarray,
                  weights: np.ndarray):
    """(means, chols, sqrt_neg_log_w) numpy arrays from mixture moments,
    weights normalized the way the reference does."""
    precs = np.linalg.inv(covars)
    chols = np.linalg.cholesky(precs)
    sqrdets = np.sqrt(np.linalg.det(covars))
    npose = means.shape[1]
    const = (2 * np.pi) ** (npose / 2.0)
    w = np.asarray(weights, np.float64).ravel()
    w = w / (const * (sqrdets / sqrdets.min()))
    w = np.clip(w, 1e-300, 1.0 - 1e-16)
    return means, chols, np.sqrt(-np.log(w))


def make_gmm_prior(dim: int, num_components: int = 8, seed: int = 0,
                   scale: float = 0.2, *, device) -> MaxMixturePrior:
    """Synthetic prior on `device` for tests and benchmarks: the same numpy
    draws as the JAX package's `make_gmm_prior`, so the same seed gives the
    same prior."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(num_components, dim)) * scale * 0.5
    covars = []
    for _ in range(num_components):
        a = rng.normal(size=(dim, dim)) * 0.1
        covars.append(scale ** 2 * (np.eye(dim) + a @ a.T))
    weights = rng.dirichlet(np.ones(num_components))
    return gmm_prior_from_arrays(*_from_moments(means, np.stack(covars),
                                                weights), device=device)
