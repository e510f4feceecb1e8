"""Deterministic synthetic SMPL-family models for tests and benchmarks.

The numpy generator of `moshpp_tpu/models/synthetic.py`, copied so that this
package builds the same arrays from the same seed without importing JAX
(tests/test_torch_models.py holds the two equal). The real model files are
license-gated; the synthetic stand-in has the same tensor shapes, kinematic
topology and pose-vector layout.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from moshpp_torch.models.body_model import (MODEL_TYPE_INFO, SurfaceModel,
                                            surface_model_from_arrays)
from moshpp_torch.models.kintree import DEFAULT_PARENTS

REAL_NUM_VERTS = {"smpl": 6890, "smplh": 6890, "smplx": 10475, "mano": 778}


def icosphere(subdivisions: int = 3):
    """Closed triangulated unit sphere (subdivided icosahedron).

    Returns (verts (V,3) float64, faces (F,3) int32).
    """
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
            (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
            (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1),
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
            (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
            (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
            (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
        ],
        dtype=np.int64,
    )
    for _ in range(subdivisions):
        edge_mid = {}
        new_faces = []
        vlist = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = vlist[a] + vlist[b]
                m /= np.linalg.norm(m)
                edge_mid[key] = len(vlist)
                vlist.append(m)
            return edge_mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        verts = np.array(vlist)
        faces = np.array(new_faces, dtype=np.int64)
    return verts, faces.astype(np.int32)


def _skeleton(parents: tuple, rng: np.random.Generator) -> np.ndarray:
    """Rest-pose joint locations: a smooth random tree in a ~1.7 m volume."""
    J = len(parents)
    joints = np.zeros((J, 3))
    for k in range(1, J):
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        length = 0.25 * (0.97 ** k) + 0.02
        joints[k] = joints[parents[k]] + d * length
    joints -= joints.mean(axis=0)
    scale = 0.85 / max(np.abs(joints).max(), 1e-6)
    return joints * scale


def synthetic_model_arrays(model_type: str = "smplh",
                           num_verts: int = 2000,
                           num_betas: int = 16,
                           num_shape_dirs: Optional[int] = None,
                           dof_per_hand: int = 12,
                           seed: int = 0,
                           real_size: bool = False) -> dict:
    """The synthetic model's arrays (numpy float32, faces int32), keyed by
    `SurfaceModel` field name. Same arguments and same arrays as the JAX
    package's `make_synthetic_model`."""
    info = MODEL_TYPE_INFO[model_type]
    parents = DEFAULT_PARENTS[model_type]
    J = len(parents)
    if J != info.num_joints:
        raise ValueError(f"{model_type}: parent table has {J} joints")
    rng = np.random.default_rng(seed)

    if real_size:
        num_verts = REAL_NUM_VERTS.get(model_type, num_verts)
    sub = 2
    while len(icosphere(sub)[0]) < num_verts and sub < 6:
        sub += 1
    sphere_v, faces = icosphere(sub)
    V = len(sphere_v)

    joints = _skeleton(parents, rng)

    bones_a = joints[np.array([max(p, 0) for p in parents])]
    bones_b = joints
    seg = bones_b - bones_a
    seg_len_sq = np.maximum((seg ** 2).sum(-1), 1e-12)

    def dist_to_bones(points):
        ap = points[:, None, :] - bones_a[None]
        t = np.clip((ap * seg[None]).sum(-1) / seg_len_sq[None], 0.0, 1.0)
        closest = bones_a[None] + t[..., None] * seg[None]
        d = np.linalg.norm(points[:, None, :] - closest, axis=-1)
        return d, closest

    radius = 0.09 + 0.05 * np.sin(3.0 * sphere_v[:, 0]) * np.cos(2.0 * sphere_v[:, 1])
    probe = sphere_v * 1.2
    d_probe, closest_probe = dist_to_bones(probe)
    j_near = np.argmin(d_probe, axis=1)
    v_template = closest_probe[np.arange(V), j_near] + sphere_v * radius[:, None]

    d, _ = dist_to_bones(v_template)
    logits = -d / 0.06
    top2 = np.argsort(logits, axis=1)[:, -2:]
    w = np.zeros((V, J))
    rows = np.arange(V)[:, None]
    lw = logits[rows, top2]
    lw = np.exp(lw - lw.max(axis=1, keepdims=True))
    w[rows, top2] = lw / lw.sum(axis=1, keepdims=True)

    k = max(4, V // (J * 8))
    jr = np.zeros((J, V))
    d_jv = np.linalg.norm(joints[:, None, :] - v_template[None], axis=-1)
    nearest = np.argsort(d_jv, axis=1)[:, :k]
    for j in range(J):
        jr[j, nearest[j]] = 1.0 / k
    joints = jr @ v_template

    B = num_shape_dirs or num_betas
    freq = rng.normal(size=(3, 3, B)) * 2.0
    phase = rng.uniform(0, 2 * np.pi, size=(3, B))
    shapedirs = 0.05 * np.sin(v_template @ freq.reshape(3, -1) + phase.reshape(1, -1)
                              ).reshape(V, 3, B)
    P = 9 * (J - 1)
    freq_p = rng.normal(size=(3, 3 * P)) * 1.5
    phase_p = rng.uniform(0, 2 * np.pi, size=(3 * P,))
    posedirs = 0.01 * np.sin(v_template @ freq_p + phase_p).reshape(V, 3, P)

    if info.has_hands:
        full_hand = 45 * info.num_hands
        if info.num_hands == 2:
            compl = rng.normal(size=(dof_per_hand, 45)) * 0.3
            compr = rng.normal(size=(dof_per_hand, 45)) * 0.3
            hands_components = np.block(
                [[compl, np.zeros_like(compl)], [np.zeros_like(compr), compr]])
        else:
            hands_components = rng.normal(size=(dof_per_hand, 45)) * 0.3
        hands_mean = rng.normal(size=(full_hand,)) * 0.05
    else:
        hands_components = np.zeros((0, 0))
        hands_mean = np.zeros((0,))

    f32 = lambda a: np.asarray(a, dtype=np.float32)
    return dict(
        v_template=f32(v_template),
        shapedirs=f32(shapedirs),
        posedirs=f32(posedirs),
        weights=f32(w),
        joint_template=f32(joints),
        joint_shapedirs=f32(np.einsum("jv,vcb->jcb", jr, shapedirs)),
        hands_components=f32(hands_components),
        hands_mean=f32(hands_mean),
        faces=faces,
    )


def make_synthetic_model(model_type: str = "smplh",
                         num_verts: int = 2000,
                         num_betas: int = 16,
                         num_shape_dirs: Optional[int] = None,
                         dof_per_hand: int = 12,
                         seed: int = 0,
                         real_size: bool = False,
                         *, device) -> SurfaceModel:
    """Build a synthetic `SurfaceModel` of the given family on `device`."""
    arrays = synthetic_model_arrays(model_type, num_verts, num_betas,
                                    num_shape_dirs, dof_per_hand, seed,
                                    real_size)
    return surface_model_from_arrays(
        arrays, model_type, DEFAULT_PARENTS[model_type], dof_per_hand,
        num_betas=num_betas, skin_k=2, device=device)
