"""Brute-force k-nearest-neighbour queries (port of `moshpp_tpu/ops/knn.py`):
a dense distance matrix and `torch.topk`."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _sq_dists(queries: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    qq = torch.sum(queries * queries, dim=-1, keepdim=True)
    pp = torch.sum(points * points, dim=-1)
    return qq - 2.0 * (queries @ points.T) + pp[None, :]


def knn(queries: torch.Tensor, points: torch.Tensor, k: int,
        exclude_mask: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest points for each query: (indices (Q, k), sq_dists (Q, k)),
    ascending by distance. `exclude_mask` (P,) bool drops points."""
    d = _sq_dists(queries, points)
    if exclude_mask is not None:
        d = torch.where(exclude_mask[None, :], torch.inf, d)
    neg_d, idx = torch.topk(-d, k, dim=-1)
    return idx, -neg_d
