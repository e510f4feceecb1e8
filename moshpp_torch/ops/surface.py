"""Triangle/vertex normals (port of `moshpp_tpu/ops/surface.py`)."""

from __future__ import annotations

import torch

_EPS = 1e-12


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + _EPS)


def face_cross(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Unnormalized face normals (2x face area), (F, 3)."""
    a = verts[faces[:, 0]]
    e1 = verts[faces[:, 1]] - a
    e2 = verts[faces[:, 2]] - a
    return torch.linalg.cross(e1, e2)


def vertex_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals, (V, 3), unit length."""
    fc = face_cross(verts, faces)
    acc = torch.zeros_like(verts)
    for c in range(3):
        acc.index_add_(0, faces[:, c].long(), fc)
    return _normalize(acc)
