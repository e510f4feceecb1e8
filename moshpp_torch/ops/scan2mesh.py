"""Scan <-> mesh distance objectives (port of `moshpp_tpu/ops/scan2mesh.py`;
reference `scan2mesh/mesh_distance_main.py`).

`sample_from_mesh` gives the reference's samplers as index/barycentric
tables, with the JAX package's numpy draws from the same seed. The
objectives return least-squares residual vectors over the closest-point
machinery of `ops/point_mesh.py`, optionally robustified.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from moshpp_torch.ops.point_mesh import (nearest_on_mesh,
                                         signed_point_to_mesh_distance)
from moshpp_torch.ops.robustifiers import signed_sqrt


class MeshSampler(NamedTuple):
    """Points = sum_k bary[:, k] * verts[vert_ids[:, k]]."""
    vert_ids: np.ndarray   # (S, 3) int
    bary: np.ndarray       # (S, 3)

    def sample(self, verts: torch.Tensor) -> torch.Tensor:
        ids = torch.as_tensor(np.asarray(self.vert_ids), dtype=torch.long,
                              device=verts.device)
        bary = torch.as_tensor(np.asarray(self.bary), dtype=verts.dtype,
                               device=verts.device)
        return torch.einsum("skc,sk->sc", verts[ids], bary)

    @property
    def num_samples(self) -> int:
        return self.vert_ids.shape[0]


def sample_from_mesh(verts: np.ndarray, faces: Optional[np.ndarray] = None,
                     sample_type: str = "uniformly-from-vertices",
                     num_samples: int = 10000,
                     vertex_indices_to_sample: Optional[np.ndarray] = None,
                     seed: int = 0) -> MeshSampler:
    """A sampler of `sample_type`: 'vertices', 'uniformly-from-vertices',
    'edge-midpoints' or 'uniformly-at-random' (area-weighted)."""
    rng = np.random.default_rng(seed)
    verts = np.asarray(verts)
    V = verts.shape[0]

    def from_vids(vids):
        ids = np.stack([vids, vids, vids], axis=1)
        bary = np.tile(np.array([[1.0, 0.0, 0.0]]), (len(vids), 1))
        return MeshSampler(vert_ids=ids, bary=bary)

    if sample_type == "vertices":
        vids = (np.arange(V) if vertex_indices_to_sample is None
                else np.asarray(vertex_indices_to_sample))
        return from_vids(vids)
    if sample_type == "uniformly-from-vertices":
        return from_vids(rng.permutation(V)[: int(min(num_samples, V))])
    if faces is None and sample_type in ("edge-midpoints",
                                         "uniformly-at-random"):
        raise ValueError(f"{sample_type} needs faces")
    if sample_type == "edge-midpoints":
        f = np.asarray(faces)
        ids = np.concatenate([f[:, [0, 1, 2]], f[:, [1, 2, 0]], f[:, [2, 0, 1]]])
        bary = np.tile(np.array([[0.5, 0.5, 0.0]]), (len(ids), 1))
        return MeshSampler(vert_ids=ids, bary=bary)
    if sample_type == "uniformly-at-random":
        f = np.asarray(faces)
        a, b, c = verts[f[:, 0]], verts[f[:, 1]], verts[f[:, 2]]
        areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
        tri = rng.choice(len(f), size=int(num_samples), p=areas / areas.sum())
        r = rng.random((int(num_samples), 2))
        flip = r.sum(1) > 1
        r[flip] = 1 - r[flip]
        bary = np.stack([1 - r[:, 0] - r[:, 1], r[:, 0], r[:, 1]], axis=1)
        return MeshSampler(vert_ids=f[tri], bary=bary)
    raise ValueError(f"unknown sample_type: {sample_type}")


def _faces(faces, device) -> torch.Tensor:
    """Faces (F, 3) as an int64 tensor on `device`, from numpy or torch."""
    if isinstance(faces, torch.Tensor):
        return faces.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(faces), dtype=torch.long, device=device)


def _distance_residual(points, ref_verts, ref_faces, rho, normalize, signed,
                       prefilter_k):
    ref_faces = _faces(ref_faces, points.device)
    n = points.shape[0]
    norm_const = float(np.sqrt(float(n))) if normalize else 1.0
    if signed:
        d = signed_point_to_mesh_distance(points, ref_verts, ref_faces,
                                          prefilter_k=prefilter_k)
        return signed_sqrt(rho(torch.sign(d) * d * d)) / norm_const
    near = nearest_on_mesh(points, ref_verts, ref_faces,
                           prefilter_k=prefilter_k)
    return torch.sqrt(rho(near.sq_dist) + 1e-12) / norm_const


def scan_to_mesh(scan_points: torch.Tensor, mesh_verts: torch.Tensor,
                 mesh_faces, rho: Callable = lambda x: x,
                 sampler: Optional[MeshSampler] = None,
                 normalize: bool = True, signed: bool = False,
                 prefilter_k: Optional[int] = 64) -> torch.Tensor:
    """Residuals of (sampled) scan points against a mesh (ScanToMesh)."""
    pts = sampler.sample(scan_points) if sampler is not None else scan_points
    return _distance_residual(pts, mesh_verts, mesh_faces, rho, normalize,
                              signed, prefilter_k)


def mesh_to_scan(mesh_verts: torch.Tensor, scan_verts: torch.Tensor,
                 scan_faces, sampler: Optional[MeshSampler] = None,
                 rho: Callable = lambda x: x, normalize: bool = True,
                 signed: bool = False,
                 prefilter_k: Optional[int] = 64) -> torch.Tensor:
    """Residuals of (sampled) mesh points against a scan (MeshToScan)."""
    pts = sampler.sample(mesh_verts) if sampler is not None else mesh_verts
    return _distance_residual(pts, scan_verts, scan_faces, rho, normalize,
                              signed, prefilter_k)


def pts_to_mesh(sample_verts: torch.Tensor, reference_verts: torch.Tensor,
                reference_faces, rho: Callable = lambda x: x,
                normalize: bool = True, signed: bool = False,
                prefilter_k: Optional[int] = 64) -> torch.Tensor:
    """An identity-sampled point set against a mesh (PtsToMesh)."""
    return _distance_residual(sample_verts, reference_verts, reference_faces,
                              rho, normalize, signed, prefilter_k)


def clamped_signed_pts_to_mesh(sample_verts: torch.Tensor,
                               reference_verts: torch.Tensor,
                               reference_faces, a_min: float, a_max: float,
                               prefilter_k: Optional[int] = 64
                               ) -> torch.Tensor:
    """Signed distance clamped to [a_min, a_max]; the derivative vanishes
    outside the band (ClampedSignedPtsToMesh)."""
    d = signed_point_to_mesh_distance(sample_verts, reference_verts,
                                      _faces(reference_faces,
                                             sample_verts.device),
                                      prefilter_k=prefilter_k)
    return torch.clamp(d, a_min, a_max)
