"""Differentiable point-to-mesh (signed) distance (port of
`moshpp_tpu/ops/point_mesh.py`).

The closest point on each triangle comes from Ericson's region method,
branch-free: the barycentric zero pattern says whether it lies inside, on
an edge or at a vertex, and derivatives (forward or reverse) flow through
the piecewise-smooth projection. The nearest primitive is a dense distance
over all faces, or over the top-k faces by centroid distance, and an argmin.

Every division goes through `_safe_div`, which replaces the denominator
before dividing, so degenerate triangles leave no NaN in a tangent.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from moshpp_torch.ops.knn import smallest_k
from moshpp_torch.ops.surface import face_cross, vertex_normals

_EPS = 1e-12
_PART_EPS = 1e-7


def _safe_div(num, den):
    ok = torch.abs(den) > _EPS
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def closest_point_on_triangles(points: torch.Tensor, tri_a: torch.Tensor,
                               tri_b: torch.Tensor,
                               tri_c: torch.Tensor) -> torch.Tensor:
    """Barycentric coordinates (..., 3) of the closest point on each
    triangle; points and corners broadcast over their leading dims (..., 3).

    The vertex regions are applied last, so they win on shared edges, as in
    the JAX package."""
    ab = tri_b - tri_a
    ac = tri_c - tri_a
    ap = points - tri_a
    d1 = _dot(ab, ap)
    d2 = _dot(ac, ap)
    bp = points - tri_b
    d3 = _dot(ab, bp)
    d4 = _dot(ac, bp)
    cp = points - tri_c
    d5 = _dot(ab, cp)
    d6 = _dot(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    zeros = torch.zeros_like(d1)
    ones = torch.ones_like(d1)

    def bary(u, v, w):
        return torch.stack([u, v, w], dim=-1)

    def put(region, value, out):
        return torch.where(region[..., None], value, out)

    # interior
    denom = va + vb + vc
    v_in = _safe_div(vb, denom)
    w_in = _safe_div(vc, denom)
    out = bary(1.0 - v_in - w_in, v_in, w_in)

    # edge bc
    in_bc = ((d4 - d3) >= 0) & ((d5 - d6) >= 0) & (va <= 0)
    w_bc = _safe_div(d4 - d3, (d4 - d3) + (d5 - d6))
    out = put(in_bc, bary(zeros, 1.0 - w_bc, w_bc), out)

    # edge ac
    in_ac = (d2 >= 0) & (d6 <= 0) & (vb <= 0)
    w_ac = _safe_div(d2, d2 - d6)
    out = put(in_ac, bary(1.0 - w_ac, zeros, w_ac), out)

    # edge ab
    in_ab = (d1 >= 0) & (d3 <= 0) & (vc <= 0)
    v_ab = _safe_div(d1, d1 - d3)
    out = put(in_ab, bary(1.0 - v_ab, v_ab, zeros), out)

    # vertex regions
    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    out = put(in_c, bary(zeros, zeros, ones), out)
    out = put(in_b, bary(zeros, ones, zeros), out)
    out = put(in_a, bary(ones, zeros, zeros), out)
    return out


def blend(bary: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
          c: torch.Tensor) -> torch.Tensor:
    """The point with barycentric coordinates `bary` on triangles (a, b, c)."""
    return bary[..., 0:1] * a + bary[..., 1:2] * b + bary[..., 2:3] * c


class NearestPrimitive(NamedTuple):
    """Nearest-surface query result for a batch of points (all (P,)-leading)."""
    tri_idx: torch.Tensor    # (P,) int64 nearest triangle
    bary: torch.Tensor       # (P, 3) clamped barycentric coords on it
    point: torch.Tensor      # (P, 3) closest surface point
    sq_dist: torch.Tensor    # (P,)


def nearest_on_mesh(points: torch.Tensor, verts: torch.Tensor,
                    faces: torch.Tensor,
                    prefilter_k: Optional[int] = 64) -> NearestPrimitive:
    """Nearest point on a triangle mesh for each of points (P, 3).

    With `prefilter_k`, the exact closest point is evaluated only on the
    top-k faces by centroid distance (None: all faces). `point` and
    `sq_dist` are differentiable in `points` and `verts`."""
    faces = faces.long()
    a_all = verts[faces[:, 0]]
    b_all = verts[faces[:, 1]]
    c_all = verts[faces[:, 2]]
    pidx = torch.arange(points.shape[0], device=points.device)
    if prefilter_k is not None and prefilter_k < faces.shape[0]:
        centroids = (a_all + b_all + c_all) / 3.0
        pp = torch.sum(centroids * centroids, dim=-1)
        d_cent = pp[None, :] - 2.0 * (points @ centroids.T)
        _, cand = smallest_k(d_cent, prefilter_k)               # (P, k)
        a, b, c = a_all[cand], b_all[cand], c_all[cand]
    else:
        cand = None
        a, b, c = a_all[None], b_all[None], c_all[None]
    pts = points[:, None, :]
    bary = closest_point_on_triangles(pts, a, b, c)
    cp = blend(bary, a, b, c)
    sq = torch.sum((pts - cp) ** 2, dim=-1)
    best = torch.argmin(sq, dim=-1)
    tri = best if cand is None else cand[pidx, best]
    return NearestPrimitive(tri_idx=tri, bary=bary[pidx, best],
                            point=cp[pidx, best], sq_dist=sq[pidx, best])


def point_to_mesh_distance(points: torch.Tensor, verts: torch.Tensor,
                           faces: torch.Tensor,
                           prefilter_k: Optional[int] = 64) -> torch.Tensor:
    """Unsigned distances (P,) from points to the mesh surface."""
    near = nearest_on_mesh(points, verts, faces, prefilter_k)
    return torch.sqrt(near.sq_dist + _EPS)


def signed_point_to_mesh_distance(points: torch.Tensor, verts: torch.Tensor,
                                  faces: torch.Tensor,
                                  prefilter_k: Optional[int] = 64
                                  ) -> torch.Tensor:
    """Signed distances (P,), positive outside: the sign of (p - closest)
    against the part-matched normal (the face normal inside a triangle,
    the sum of the supporting corners' vertex normals on an edge or at a
    vertex); +1 where that product is exactly zero."""
    faces = faces.long()
    near = nearest_on_mesh(points, verts, faces, prefilter_k)
    fn = face_cross(verts, faces)
    vn = vertex_normals(verts, faces)
    tri = faces[near.tri_idx]                               # (P, 3)
    on_corner = near.bary > _PART_EPS
    interior = torch.all(on_corner, dim=-1)
    corner_n = torch.einsum("pc,pcx->px", on_corner.to(verts.dtype), vn[tri])
    normal = torch.where(interior[:, None], fn[near.tri_idx], corner_n)
    sign = torch.sign(torch.sum((points - near.point) * normal.detach(),
                                dim=-1))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    return sign * torch.sqrt(near.sq_dist + _EPS)
