"""Brute-force k-nearest-neighbour queries (port of `moshpp_tpu/ops/knn.py`):
a dense distance matrix and a stable sort."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _sq_dists(queries: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    qq = torch.sum(queries * queries, dim=-1, keepdim=True)
    pp = torch.sum(points * points, dim=-1)
    return qq - 2.0 * (queries @ points.T) + pp[None, :]


def smallest_k(d: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k smallest entries of each row of d,
    ascending, equal values in index order: `jax.lax.top_k` of -d. The
    synthetic meshes are symmetric, so exact ties are common, and
    `torch.topk` orders them otherwise (a marker's frame vertices then
    differ from the JAX package's)."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def knn(queries: torch.Tensor, points: torch.Tensor, k: int,
        exclude_mask: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest points for each query: (indices (Q, k), sq_dists (Q, k)),
    ascending by distance. `exclude_mask` (P,) bool drops points."""
    d = _sq_dists(queries, points)
    if exclude_mask is not None:
        d = torch.where(exclude_mask[None, :], torch.inf, d)
    d_k, idx = smallest_k(d, k)
    return idx, d_k


def nearest_vertex(queries: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Index (Q,) of the nearest point for each query (the reference's
    kd-tree snap of the latent markers to vertices)."""
    return torch.argmin(_sq_dists(queries, points), dim=-1)
