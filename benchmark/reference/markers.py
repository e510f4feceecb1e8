"""Latent markers carried with the skin (MoSh, Loper et al. 2014, and
MoSh++, Mahmood et al. 2019): a marker is three coefficients on a local
orthonormal frame of three nearby vertices of the canonical body, and the
same frame rebuilt on a posed body carries it.

The frame of a marker: c0 and c1 its two nearest canonical vertices, c2 the
nearest of the next six whose edge from c0 is not collinear with c0->c1;
f1 = unit(c1 - c0), f2 = unit((c1 - c0) x (c2 - c0)), f3 = f1 x f2.
"""

from __future__ import annotations

import torch

_EPS = 1e-12
_COLLINEAR_SQ = 1e-16


def vertex_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted unit vertex normals (V, 3) of a triangle mesh."""
    a, b, c = (verts[faces[:, i]] for i in range(3))
    fn = torch.linalg.cross(b - a, c - a)
    n = torch.zeros_like(verts)
    for i in range(3):
        n.index_add_(0, faces[:, i], fn)
    return n / torch.linalg.vector_norm(n, dim=1, keepdim=True)


def frame_vertices(can_verts: torch.Tensor, latents: torch.Tensor,
                   k: int = 8) -> torch.Tensor:
    """(M, 3) vertex indices (c0, c1, c2) of each latent marker's frame,
    nearest first; equal distances in index order."""
    d = ((latents[:, None, :] - can_verts[None]) ** 2).sum(-1)
    nn = torch.sort(d, dim=1, stable=True)[1][:, :k]
    v0 = can_verts[nn[:, 0]]
    e1 = can_verts[nn[:, 1]] - v0
    cand = can_verts[nn[:, 2:]] - v0[:, None]
    cr = torch.linalg.cross(e1[:, None].expand_as(cand), cand)
    ok = (cr * cr).sum(-1) > _COLLINEAR_SQ
    first = torch.argmax(ok.to(torch.int32), dim=1)
    c2 = torch.gather(nn[:, 2:], 1, first[:, None])[:, 0]
    return torch.stack([nn[:, 0], nn[:, 1], c2], dim=1)


def _unit(x):
    return x / torch.sqrt((x * x).sum(-1, keepdim=True) + _EPS)


def _frames(p0, p1, p2):
    e1 = p1 - p0
    f1 = _unit(e1)
    f2 = _unit(torch.linalg.cross(e1, p2 - p0))
    return f1, f2, torch.linalg.cross(f1, f2)


def marker_coefficients(can_verts: torch.Tensor, latents: torch.Tensor,
                        frame: torch.Tensor) -> torch.Tensor:
    """(M, 3) projections of each latent marker on its canonical frame."""
    p0, p1, p2 = (can_verts[frame[:, i]] for i in range(3))
    d = latents - p0
    return torch.stack([(d * f).sum(-1) for f in _frames(p0, p1, p2)], 1)


def place_markers(frame_verts: torch.Tensor,
                  coeffs: torch.Tensor) -> torch.Tensor:
    """Markers (N, M, 3) from posed frame vertices (N, M, 3, 3) [n, m, c_i,
    xyz] and their coefficients (M, 3)."""
    p0, p1, p2 = (frame_verts[:, :, i] for i in range(3))
    f1, f2, f3 = _frames(p0, p1, p2)
    return (p0 + coeffs[:, 0:1] * f1 + coeffs[:, 1:2] * f2
            + coeffs[:, 2:3] * f3)
