"""Latent-marker local-frame transport (port of
`moshpp_tpu/ops/marker_transform.py`).

A latent marker is three projection coefficients onto a local orthonormal
frame built from its nearest canonical-body vertices; the same frame rebuilt
on a posed body carries the marker with the skin.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from moshpp_torch.ops.knn import knn

_EPS = 1e-12
_DEGENERATE_CROSS_SQ = 1e-16


class MarkerFrameIndices(NamedTuple):
    """Per-marker vertex triple defining its local frame, (M,) int64 each."""
    c0: torch.Tensor
    c1: torch.Tensor
    c2: torch.Tensor

    @property
    def stacked(self) -> torch.Tensor:
        return torch.stack([self.c0, self.c1, self.c2], dim=1)


def _normalize(x):
    return x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + _EPS)


def _frames(verts: torch.Tensor, idx: MarkerFrameIndices):
    """Frame (v0, f1, f2, f3) of every marker; verts (..., V, 3)."""
    v0 = verts[..., idx.c0, :]
    e1 = verts[..., idx.c1, :] - v0
    e2 = verts[..., idx.c2, :] - v0
    f1 = _normalize(e1)
    f2 = _normalize(torch.linalg.cross(e1, e2))
    f3 = torch.linalg.cross(f1, f2)
    return v0, f1, f2, f3


def select_frame_indices(can_verts: torch.Tensor,
                         markers_latent: torch.Tensor,
                         k: int = 8,
                         exclude_mask: Optional[torch.Tensor] = None
                         ) -> MarkerFrameIndices:
    """c0, c1 are the two nearest vertices; c2 the nearest remaining one
    whose edge is not collinear with e1."""
    nn_idx, _ = knn(markers_latent, can_verts, k=k, exclude_mask=exclude_mask)
    c0, c1 = nn_idx[:, 0], nn_idx[:, 1]
    v0 = can_verts[c0]
    e1 = can_verts[c1] - v0
    cand = can_verts[nn_idx[:, 2:]] - v0[:, None, :]
    cross = torch.linalg.cross(e1[:, None, :].expand_as(cand), cand)
    ok = torch.sum(cross * cross, dim=-1) > _DEGENERATE_CROSS_SQ
    first_ok = torch.argmax(ok.to(torch.int32), dim=-1)
    c2 = torch.gather(nn_idx[:, 2:], 1, first_ok[:, None])[:, 0]
    return MarkerFrameIndices(c0=c0, c1=c1, c2=c2)


def marker_coeffs(can_verts: torch.Tensor,
                  markers_latent: torch.Tensor,
                  idx: MarkerFrameIndices) -> torch.Tensor:
    """Projection coefficients (M, 3) of markers onto their local frames."""
    v0, f1, f2, f3 = _frames(can_verts, idx)
    diff = markers_latent - v0
    return torch.stack(
        [torch.sum(diff * f, dim=-1) for f in (f1, f2, f3)], dim=1)


def reconstruct_markers(posed_verts: torch.Tensor,
                        idx: MarkerFrameIndices,
                        coeffs: torch.Tensor) -> torch.Tensor:
    """Marker positions (..., M, 3) on posed bodies (..., V, 3)."""
    v0, f1, f2, f3 = _frames(posed_verts, idx)
    return (v0 + coeffs[:, 0:1] * f1 + coeffs[:, 1:2] * f2
            + coeffs[:, 2:3] * f3)


def transport_markers(can_verts: torch.Tensor,
                      markers_latent: torch.Tensor,
                      posed_verts: torch.Tensor,
                      idx: MarkerFrameIndices) -> torch.Tensor:
    """Latent markers carried from the canonical body (V, 3) onto posed
    bodies (..., V, 3): their coefficients on the canonical frames, then
    the markers rebuilt on the posed frames, in one call (the
    TransformedCoeffs -> TransformedLms chain of stage i,
    chmosh.py:182-191)."""
    coeffs = marker_coeffs(can_verts, markers_latent, idx)
    return reconstruct_markers(posed_verts, idx, coeffs)
