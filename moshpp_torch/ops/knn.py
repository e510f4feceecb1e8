"""Brute-force k-nearest-neighbour queries (port of `moshpp_tpu/ops/knn.py`):
a dense distance matrix and a stable sort.

The ranking is exact and the same on every device, a deliberate difference
from the JAX package: `_sq_dists` sums the squared coordinate differences,
where the JAX package expands |q|^2 - 2 q.p + |p|^2. At 1 m from the origin
the expansion cancels to ~1e-7 m^2, against squared marker-to-vertex
distances of ~1e-4 m^2, so a near-tie (a latent marker on its vertex's
normal) goes to whatever the device's matmul rounds; the card and the CPU
that built a session then pick other frame vertices."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _sq_dists(queries: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(Q, P) squared distances as dx*dx + dy*dy + dz*dz: three elementwise
    products and two additions in that order, no matmul and no reduction
    (whose association differs between the CPU and the card). Each float32
    elementwise operation is correctly rounded on both, so the card's matrix
    is the CPU's bit for bit."""
    d = queries[:, None, :] - points[None, :, :]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    return dx * dx + dy * dy + dz * dz


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
    kd-tree snap of the latent markers to vertices); the first of equal
    distances, as `jnp.argmin` takes it."""
    return smallest_k(_sq_dists(queries, points), 1)[1][:, 0]
