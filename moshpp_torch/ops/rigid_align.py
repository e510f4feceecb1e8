"""Weighted Kabsch/Arun rigid alignment (port of
`moshpp_tpu/ops/rigid_align.py`), batched over a leading dimension."""

from __future__ import annotations

from typing import Tuple

import torch

_EPS = 1e-12


def kabsch(src: torch.Tensor, dst: torch.Tensor,
           weights: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Least-squares rigid transforms R @ src + t ~= dst.

    src, dst (N, K, 3), weights (N, K) nonnegative (0 = ignore the pair) ->
    (R (N, 3, 3), t (N, 3)), proper rotations (reflection fixed).
    """
    w = weights[..., None]
    wsum = torch.sum(weights, dim=-1)[..., None] + _EPS
    src_mean = torch.sum(src * w, dim=-2) / wsum
    dst_mean = torch.sum(dst * w, dim=-2) / wsum
    a = src - src_mean[..., None, :]
    b = dst - dst_mean[..., None, :]
    c = (a * w).transpose(-1, -2) @ b
    u, _, vt = torch.linalg.svd(c, full_matrices=False)
    v = vt.transpose(-1, -2)
    det = torch.linalg.det(v @ u.transpose(-1, -2))
    d = torch.ones(det.shape + (3,), dtype=src.dtype, device=src.device)
    d[..., 2] = det
    rot = (v * d[..., None, :]) @ u.transpose(-1, -2)
    t = dst_mean - torch.einsum("...ab,...b->...a", rot, src_mean)
    return rot, t
