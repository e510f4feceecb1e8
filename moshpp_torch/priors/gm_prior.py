"""Graphical-lasso pose prior (port of `moshpp_tpu/priors/gm_prior.py`;
reference `prior/gm_prior_ch.py`).

Fits a sparse-precision Gaussian to a pose corpus per subject and exposes a
Mahalanobis whitening residual. With `use_sklearn` it tries sklearn's
GraphicalLassoCV and otherwise takes a shrinkage empirical precision, as the
JAX package does; where sklearn is not installed (the machine with the H100
has none) it takes the shrinkage path.
"""

from __future__ import annotations

import numpy as np

from moshpp_torch.priors.mahalanobis import (MahalanobisPrior,
                                             mahalanobis_prior_from_arrays)


def fit_graphical_lasso_prior(pose_samples: np.ndarray,
                              use_sklearn: bool = True,
                              *, device) -> MahalanobisPrior:
    """pose_samples: (N, D) corpus of poses; a whitening prior on `device`
    whose residual is (x - mean) @ chol(precision)."""
    mean = pose_samples.mean(axis=0)
    prec = None
    if use_sklearn:
        try:
            from sklearn.covariance import GraphicalLassoCV
            prec = GraphicalLassoCV().fit(pose_samples).precision_
        except (ImportError, ValueError, FloatingPointError):
            prec = None    # no sklearn, or the fit failed
    if prec is None:
        cov = np.cov(pose_samples.T) + 1e-4 * np.eye(pose_samples.shape[1])
        prec = np.linalg.inv(cov)
    return mahalanobis_prior_from_arrays(mean, np.linalg.cholesky(prec),
                                         device=device)


class SubjectPriorCache:
    """Per-subject graphical-lasso priors with the reference's cache
    semantics (`gm_prior_ch.py:45-78`): a 'Generic' prior fitted over the
    whole corpus, plus per-subject priors fitted on first use from the
    samples whose names contain the subject id, falling back to Generic
    when fewer than `min_samples` match. Priors live on `device`.
    """

    def __init__(self, pose_samples: np.ndarray, sample_names,
                 min_samples: int = 3, use_sklearn: bool = True, *, device):
        self._samples = np.asarray(pose_samples)
        self._names = [str(n).lower() for n in sample_names]
        self._min = min_samples
        self._sk = use_sklearn
        self._device = device
        self._cache = {"Generic": fit_graphical_lasso_prior(
            self._samples, use_sklearn=use_sklearn, device=device)}

    def __getitem__(self, subject_id: str) -> MahalanobisPrior:
        if subject_id not in self._cache:
            sel = [i for i, n in enumerate(self._names)
                   if subject_id.lower() in n]
            if len(sel) < self._min:
                self._cache[subject_id] = self._cache["Generic"]
            else:
                self._cache[subject_id] = fit_graphical_lasso_prior(
                    self._samples[sel], use_sklearn=self._sk,
                    device=self._device)
        return self._cache[subject_id]
