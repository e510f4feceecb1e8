"""Mahalanobis-style animal pose priors (port of
`moshpp_tpu/priors/mahalanobis.py`; reference `prior/horse_body_prior.py`,
`prior/dog_body_prior.py`).

The horse's prior is a callable on one frame's body slice, (81,) -> (93,):
the Mahalanobis rows and the leg-bend rows at twice their weight
(`horse_prior`). The stage-ii system takes its rows and Jacobian for all
frames at once under `torch.func.vmap(torch.func.jacfwd(...))`, so it uses
no in-place ops and reads no value to the host. The dog's prior is a
max-mixture GMM over a 31-joint subset of its pose.
"""

from __future__ import annotations

import dataclasses
import functools
import pickle

import numpy as np
import torch

from moshpp_torch.priors.gmm import MaxMixturePrior, load_gmm_prior


@dataclasses.dataclass(frozen=True)
class MahalanobisPrior:
    mean: torch.Tensor   # (D,)
    prec: torch.Tensor   # (D, D) precision (or its square-root) matrix


def mahalanobis_prior_from_arrays(mean, prec, *, device) -> MahalanobisPrior:
    """Prior on `device` from numpy arrays (e.g. the fields of a JAX
    prior)."""
    t = lambda a: torch.as_tensor(np.array(a, np.float32), device=device)
    return MahalanobisPrior(t(mean), t(prec))


def mahalanobis_residual(prior: MahalanobisPrior,
                         x: torch.Tensor) -> torch.Tensor:
    """(x - mean) @ prec for x (..., D), as smal_horse_prior
    (horse_body_prior.py:49-50)."""
    return (x - prior.mean) @ prior.prec


def load_horse_prior(fname: str, disable_tail_mouth_ear: bool = True,
                     *, device) -> MahalanobisPrior:
    """The horse prior pkl (keys `pic`, `mean_pose`) on `device`; by default
    its first 81 dofs, the body without the tail, mouth and ears."""
    with open(fname, "rb") as f:
        res = pickle.load(f, encoding="latin-1")
    n = 81 if disable_tail_mouth_ear else None
    return mahalanobis_prior_from_arrays(np.asarray(res["mean_pose"])[:n],
                                         np.asarray(res["pic"])[:n, :n],
                                         device=device)


# 90-degree leg-bend exponential penalty dofs (horse_body_prior.py:62-63),
# indices into the rootless body pose
_HORSE_ANGLE_IDS = np.array([6, 7, 8, 11, 12, 13, 20, 21, 22, 25, 26, 27]) - 3


@functools.lru_cache(maxsize=None)
def _horse_angle_ids(device: torch.device) -> torch.Tensor:
    """The leg-bend dofs' indices on `device`, copied there once: a copy
    from the host inside a stage-ii iteration would break its CUDA graph's
    capture."""
    return torch.as_tensor(_HORSE_ANGLE_IDS, device=device)


def horse_joint_angle_residual(pose_body: torch.Tensor) -> torch.Tensor:
    """exp(angle)^2 on the 12 leg-bend dofs (horse_body_prior.py:67-69),
    pose_body (..., 81) -> (..., 12)."""
    ids = _horse_angle_ids(pose_body.device)
    return torch.exp(torch.index_select(pose_body, -1, ids)) ** 2


def horse_prior(prior: MahalanobisPrior):
    """The horse's callable prior (81,) -> (93,), as the JAX head wires it
    (chmosh.py:356-358, 615-617): the Mahalanobis rows, then the leg-bend
    rows at 2x weight."""
    def rows(pose_body: torch.Tensor) -> torch.Tensor:
        return torch.cat([mahalanobis_residual(prior, pose_body),
                          2.0 * horse_joint_angle_residual(pose_body)], dim=-1)
    return rows


# the dog GMM is over a 31-joint subset (dog_body_prior.py:56-58)
_DOG_JOINT_IDS = [1, 3, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
                  20, 21, 22, 23, 24, 25, 26, 27, 28, 30, 31, 32, 33, 34]
DOG_POSE_IDS = np.arange(105).reshape(-1, 3)[_DOG_JOINT_IDS].reshape(-1)


def load_dog_prior(fname: str, *, device) -> MaxMixturePrior:
    """Max-mixture prior over the dog pose subset, on `device`; it applies to
    fullpose[DOG_POSE_IDS]."""
    return load_gmm_prior(fname, device=device)
