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
import pickle
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MaxMixturePrior:
    means: torch.Tensor           # (K, D)
    chols: torch.Tensor           # (K, D, D) cholesky factors of the precisions
    sqrt_neg_log_w: torch.Tensor  # (K,)

    @property
    def dim(self) -> int:
        return self.means.shape[1]


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


def synthetic_covariances(rng: np.random.Generator, dim: int,
                          num_components: int, scale: float) -> np.ndarray:
    """(K, dim, dim) covariances scale^2 (I + A A^T), A ~ N(0, 0.1^2), drawn
    from `rng` as the JAX package's synthetic prior draws them."""
    out = []
    for _ in range(num_components):
        a = rng.normal(size=(dim, dim)) * 0.1
        out.append(scale ** 2 * (np.eye(dim) + a @ a.T))
    return np.stack(out)


def gmm_moments(dim: int, num_components: int = 8, seed: int = 0,
                scale: float = 0.2) -> dict:
    """The synthetic mixture's moments ({'means', 'covars', 'weights'},
    the reference's pose_body_prior.pkl keys): the same numpy draws as the
    JAX package's `make_gmm_prior`."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(num_components, dim)) * scale * 0.5
    covars = synthetic_covariances(rng, dim, num_components, scale)
    return {"means": means, "covars": covars,
            "weights": rng.dirichlet(np.ones(num_components))}


def make_gmm_prior(dim: int, num_components: int = 8, seed: int = 0,
                   scale: float = 0.2, *, device) -> MaxMixturePrior:
    """Synthetic prior on `device` for tests and benchmarks: the prior of
    `gmm_moments(dim, num_components, seed, scale)`, so the same seed gives
    the JAX package's prior."""
    m = gmm_moments(dim, num_components, seed, scale)
    return gmm_prior_from_arrays(
        *_from_moments(m["means"], m["covars"], m["weights"]), device=device)


def load_gmm_prior(fname: str, npose: Optional[int] = None,
                   *, device) -> MaxMixturePrior:
    """Load a mixture prior file onto `device`.

    Takes the formats of the JAX package's loader: the reference's
    pose_body_prior.pkl dict ({'covars', 'means', 'weights'}), a pickled
    object with sklearn-GMM attributes (means_, covars_, weights_), the dog
    prior dict (gmm_means, gmm_covs, gmm_weights) and .npz. `npose` keeps
    the leading npose dims (63 leaves out the hands)."""
    if fname.endswith(".npz"):
        with np.load(fname, allow_pickle=True) as z:
            gmm = dict(z)
    else:
        with open(fname, "rb") as f:
            gmm = pickle.load(f, encoding="latin-1")
    if hasattr(gmm, "means_"):
        means, covars, weights = gmm.means_, gmm.covars_, gmm.weights_
    else:
        key = lambda *ks: next(gmm[k] for k in ks if k in gmm)
        means = key("means", "gmm_means")
        covars = key("covars", "gmm_covs", "covs")
        weights = key("weights", "gmm_weights")
    means, covars = np.asarray(means), np.asarray(covars)
    if npose is not None:
        means = means[:, :npose]
        covars = covars[:, :npose, :npose]
    return gmm_prior_from_arrays(*_from_moments(means, covars,
                                                np.asarray(weights)),
                                 device=device)


def sample_gmm_prior(prior: MaxMixturePrior, rng: np.random.Generator,
                     n: int) -> np.ndarray:
    """n pose slices (n, D) float32 drawn from the mixture the prior models,
    with the JAX package's draws from `rng` (the same generator state gives
    the same samples).

    Synthetic ground truth must come from the distribution the prior was fit
    to, as real mocap comes from the distribution of the reference's
    AMASS-trained prior: poses from an unrelated distribution make the prior
    adversarial and move the objective's optimum off the truth. `chols` are
    Cholesky factors L of the precisions, so a sample is mean + L^-T z.
    """
    import scipy.linalg

    means = prior.means.detach().cpu().numpy().astype(np.float64)
    chols = prior.chols.detach().cpu().numpy().astype(np.float64)
    K, D = means.shape
    # sqrt_neg_log_w holds the weights divided by each component's
    # normalizer (_from_moments); multiply sqrt(det cov_k) = 1/prod(diag
    # L_k) back in (the constant factors cancel in the normalization)
    w_stored = np.exp(-prior.sqrt_neg_log_w.detach().cpu().numpy().astype(
        np.float64) ** 2)
    w = w_stored / np.abs(np.prod(np.diagonal(chols, axis1=1, axis2=2),
                                  axis=1))
    w = w / w.sum()
    comps = rng.choice(K, size=n, p=w)
    z = rng.standard_normal((n, D))
    out = np.empty((n, D), np.float64)
    for i, k in enumerate(comps):
        out[i] = means[k] + scipy.linalg.solve_triangular(
            chols[k].T, z[i], lower=False)
    return out.astype(np.float32)


def save_gmm_prior_pkl(prior_moments: dict, fname: str) -> None:
    """Write mixture moments ({'means', 'covars', 'weights'} or the dog's
    keys) as the reference's pkl dict, e.g. for fixtures."""
    with open(fname, "wb") as f:
        pickle.dump(prior_moments, f)
