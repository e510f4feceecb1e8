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


def _incident_faces(faces: torch.Tensor, num_verts: int) -> torch.Tensor:
    """(V, K) the faces at each vertex in increasing order, K the largest
    valence, padded with the face count F."""
    F = faces.shape[0]
    vid = faces.reshape(-1)                          # face-major corners
    order = torch.argsort(vid, stable=True)
    counts = torch.bincount(vid, minlength=num_verts)
    start = torch.cumsum(counts, 0) - counts
    sv = vid[order]
    slot = torch.arange(3 * F, device=faces.device) - start[sv]
    table = torch.full((num_verts, int(counts.max())), F, dtype=torch.long,
                       device=faces.device)
    table[sv, slot] = order // 3
    return table


def vertex_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals, (V, 3), unit length.

    Each vertex sums its faces' cross products by a gather in a fixed order
    (no atomic scatter), so the card gives the same normals every run."""
    fc = face_cross(verts, faces)
    fc = torch.cat([fc, fc.new_zeros((1, 3))])
    table = _incident_faces(faces.long(), verts.shape[0])
    return _normalize(fc[table].sum(dim=1))
