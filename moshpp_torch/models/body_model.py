"""SMPL-family articulated body models on torch tensors.

Port of `moshpp_tpu/models/body_model.py`: the same static tables
(`MODEL_TYPE_INFO`, `pose_part_ids`, the tree helpers), a `SurfaceModel`
that is a frozen dataclass of tensors on one device, and a batched
`lbs_forward`. Frames are a leading batch dimension written out; there is no
`vmap`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from moshpp_torch.ops.rodrigues import rodrigues


@dataclasses.dataclass(frozen=True)
class ModelTypeInfo:
    """Static per-model-family metadata."""

    num_joints: int
    body_pose_dof: int        # root + articulated body dof in the *pose* vector
    has_hands: bool = False   # hand-PCA tail in the pose vector
    num_hands: int = 0
    face_pose_ids: Tuple[int, int] = (0, 0)   # jaw slice within pose vector
    toes_pose_ids: Tuple[int, int] = (0, 0)   # pose ids frozen unless optimize_toes


MODEL_TYPE_INFO = {
    "object": ModelTypeInfo(num_joints=1, body_pose_dof=3),
    "smpl": ModelTypeInfo(num_joints=24, body_pose_dof=72, toes_pose_ids=(30, 36)),
    "smplh": ModelTypeInfo(num_joints=52, body_pose_dof=66, has_hands=True,
                           num_hands=2, toes_pose_ids=(30, 36)),
    "smplx": ModelTypeInfo(num_joints=55, body_pose_dof=75, has_hands=True,
                           num_hands=2, face_pose_ids=(66, 69), toes_pose_ids=(30, 36)),
    "mano": ModelTypeInfo(num_joints=16, body_pose_dof=3, has_hands=True, num_hands=1),
    "animal_horse": ModelTypeInfo(num_joints=36, body_pose_dof=108),
    "animal_dog": ModelTypeInfo(num_joints=35, body_pose_dof=105),
}

_ARRAY_FIELDS = ("v_template", "shapedirs", "posedirs", "weights",
                 "joint_template", "joint_shapedirs", "hands_components",
                 "hands_mean", "faces")


@dataclasses.dataclass(frozen=True)
class SurfaceModel:
    """One SMPL-family model instance as tensors on one device."""

    v_template: torch.Tensor          # (V, 3)
    shapedirs: torch.Tensor           # (V, 3, B)
    posedirs: torch.Tensor            # (V, 3, 9*(J-1))
    weights: torch.Tensor             # (V, J)
    joint_template: torch.Tensor      # (J, 3)
    joint_shapedirs: torch.Tensor     # (J, 3, B)
    hands_components: torch.Tensor    # (Hdof, 45*num_hands)
    hands_mean: torch.Tensor          # (45*num_hands,)
    faces: torch.Tensor               # (F, 3) int64, full-mesh triangulation

    model_type: str = "smplh"
    parents: Tuple[int, ...] = ()
    num_betas: int = 16
    dof_per_hand: int = 12
    # max nonzero skinning weights per vertex; 0 = dense
    skin_k: int = 0

    @property
    def num_joints(self) -> int:
        return len(self.parents)

    @property
    def info(self) -> ModelTypeInfo:
        return MODEL_TYPE_INFO[self.model_type]

    @property
    def pose_dof(self) -> int:
        """Length of the optimization pose vector (body dof + PCA hand dof)."""
        info = self.info
        if info.has_hands:
            return info.body_pose_dof + self.dof_per_hand * info.num_hands
        return info.body_pose_dof

    @property
    def num_shape_dirs(self) -> int:
        return self.shapedirs.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.v_template.device

    def subset(self, vids) -> "SurfaceModel":
        """Gather per-vertex rows to a vertex subset (joints are unchanged,
        so posed positions of the retained vertices are identical)."""
        vids = torch.as_tensor(np.asarray(vids), dtype=torch.long,
                               device=self.device)
        return dataclasses.replace(
            self,
            v_template=self.v_template[vids],
            shapedirs=self.shapedirs[vids],
            posedirs=self.posedirs[vids],
            weights=self.weights[vids],
        )

    def to(self, device) -> "SurfaceModel":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in _ARRAY_FIELDS})


def surface_model_from_arrays(arrays: dict, model_type: str,
                              parents: Tuple[int, ...], dof_per_hand: int,
                              num_betas: int = 16, skin_k: int = 0,
                              *, device) -> SurfaceModel:
    """Build a `SurfaceModel` on `device` from numpy arrays keyed by field
    name.

    Float fields become float32 tensors, `faces` int64. Missing hand arrays
    become zero-size tensors."""
    def f32(name, shape=None):
        a = arrays.get(name)
        if a is None:
            a = np.zeros(shape, np.float32)
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return SurfaceModel(
        v_template=f32("v_template"),
        shapedirs=f32("shapedirs"),
        posedirs=f32("posedirs"),
        weights=f32("weights"),
        joint_template=f32("joint_template"),
        joint_shapedirs=f32("joint_shapedirs"),
        hands_components=f32("hands_components", (0, 0)),
        hands_mean=f32("hands_mean", (0,)),
        faces=torch.as_tensor(np.asarray(arrays["faces"], np.int64),
                              device=device),
        model_type=model_type,
        parents=tuple(int(p) for p in parents),
        num_betas=int(num_betas),
        dof_per_hand=int(dof_per_hand),
        skin_k=int(skin_k),
    )


def pose_part_ids(model_type: str, optimize_toes: bool = False) -> dict:
    """Pose-vector index groups per model family (see the JAX package)."""
    info = MODEL_TYPE_INFO[model_type]
    total = info.body_pose_dof
    all_ids = list(range(total))
    parts = {"root": all_ids[:3], "body": [], "finger": [], "face": []}
    if model_type == "smpl":
        parts["body"] = all_ids[3:]
    elif model_type == "smplh":
        parts["body"] = all_ids[3:66]
    elif model_type == "smplx":
        parts["body"] = all_ids[3:66]
        parts["face"] = all_ids[66:69]
    elif model_type == "mano":
        pass
    elif model_type == "animal_horse":
        parts["body"] = all_ids[3:84]
    elif model_type == "animal_dog":
        joint_ids = [1, 3, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
                     20, 21, 22, 23, 24, 25, 26, 27, 28, 30, 31, 32, 33, 34]
        parts["body"] = sorted(np.arange(105).reshape(-1, 3)[joint_ids].reshape(-1).tolist())
    if info.has_hands:
        parts["finger_start"] = info.body_pose_dof
    if not optimize_toes and parts["body"]:
        lo, hi = info.toes_pose_ids
        toes = set(range(lo, hi))
        parts["body"] = [i for i in parts["body"] if i not in toes]
    return parts


def effective_weights(model: SurfaceModel) -> torch.Tensor:
    """The dense (V, J) skinning weights `lbs_forward` applies: top-`skin_k`
    support per vertex when `skin_k` is set, else the raw weights."""
    if 0 < model.skin_k < model.num_joints:
        w_k, j_k = torch.topk(model.weights, model.skin_k, dim=1)
        return torch.zeros_like(model.weights).scatter(1, j_k, w_k)
    return model.weights


def fullpose_from_pose(model: SurfaceModel, pose: torch.Tensor) -> torch.Tensor:
    """Expand (..., pose_dof) optimization poses into per-joint axis-angles:
    the hand tail holds PCA coefficients for SMPL+H / SMPL-X / MANO."""
    info = model.info
    if not info.has_hands:
        return pose
    body = pose[..., : info.body_pose_dof]
    coeffs = pose[..., info.body_pose_dof:]
    hands = model.hands_mean + coeffs @ model.hands_components
    return torch.cat([body, hands], dim=-1)


@functools.lru_cache(maxsize=None)
def tree_depths(parents: Tuple[int, ...]) -> Tuple[int, ...]:
    """Depth of every joint (roots at 0); parents precede children."""
    depth = [0] * len(parents)
    for k in range(len(parents)):
        if parents[k] >= 0:
            depth[k] = depth[parents[k]] + 1
    return tuple(depth)


@functools.lru_cache(maxsize=None)
def _tree_levels(parents: Tuple[int, ...]):
    """Per depth level >= 1: (joint_ids, parent_ids) numpy arrays."""
    depth = tree_depths(parents)
    levels = []
    for d in range(1, max(depth) + 1):
        ids = np.array([k for k in range(len(parents)) if depth[k] == d], np.int64)
        levels.append((ids, np.array([parents[k] for k in ids], np.int64)))
    return tuple(levels)


@functools.lru_cache(maxsize=None)
def _ancestor_matrix(parents: Tuple[int, ...]) -> np.ndarray:
    """(J, J) float mask: anc[k, j] = 1 iff j is on the root->k path
    (including k itself)."""
    J = len(parents)
    anc = np.zeros((J, J), np.float32)
    for k in range(J):
        j = k
        while j >= 0:
            anc[k, j] = 1.0
            j = parents[j]
    return anc


def rel_trans(joints: torch.Tensor, parents: Tuple[int, ...]) -> torch.Tensor:
    """Parent-relative rest joints (..., J, 3); roots keep their position."""
    par = torch.as_tensor([max(p, 0) for p in parents], device=joints.device)
    root = torch.as_tensor([p < 0 for p in parents], device=joints.device)
    return torch.where(root[:, None], joints, joints - joints[..., par, :])


def fk_globals(joints: torch.Tensor, rotmats: torch.Tensor,
               parents: Tuple[int, ...]):
    """Global joint rotations (..., J, 3, 3) and translations (..., J, 3)
    over the kinematic tree, one tree level at a time.

    joints: (J, 3) or (..., J, 3) rest joints; rotmats: (..., J, 3, 3)."""
    t_rel = rel_trans(joints, parents).expand(rotmats.shape[:-1])
    G_rot = rotmats.clone()
    # like rotmats, not a clone of t_rel: under `torch.func.vmap` over the
    # poses with shared rest joints the levels below write batched values
    G_tr = torch.empty_like(rotmats[..., 0])
    G_tr.copy_(t_rel)
    dev = rotmats.device
    for ids, pids in _tree_levels(parents):
        ids_t = torch.as_tensor(ids, device=dev)
        pids_t = torch.as_tensor(pids, device=dev)
        Gp_rot = G_rot[..., pids_t, :, :]
        G_rot[..., ids_t, :, :] = Gp_rot @ rotmats[..., ids_t, :, :]
        G_tr[..., ids_t, :] = (torch.einsum("...jab,...jb->...ja", Gp_rot,
                                            t_rel[..., ids_t, :])
                               + G_tr[..., pids_t, :])
    return G_rot, G_tr


def forward_kinematics(joints: torch.Tensor, rotmats: torch.Tensor,
                       parents: Tuple[int, ...]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rigid FK over the kinematic tree (`fk_globals`), in the JAX
    package's contract (`moshpp_tpu/models/body_model.py:356`).

    joints (..., J, 3) rest joints; rotmats (..., J, 3, 3) local rotations;
    parents[k] the parent of joint k (-1 at a root). Returns (A, posed): A
    (..., J, 4, 4), the skinning transforms relative to the rest pose (the
    translation already reduced by G_k[:3, :3] @ j_k), and the posed joints
    (..., J, 3)."""
    G_rot, G_tr = fk_globals(joints, rotmats, parents)
    A = torch.zeros(G_rot.shape[:-2] + (4, 4), dtype=G_rot.dtype,
                    device=G_rot.device)
    A[..., :3, :3] = G_rot
    A[..., :3, 3] = G_tr - torch.einsum("...jab,...jb->...ja", G_rot, joints)
    A[..., 3, 3] = 1.0
    return A, G_tr


def lbs_forward(model: SurfaceModel,
                pose: torch.Tensor,
                betas: torch.Tensor,
                trans: torch.Tensor,
                want_joints: bool = False):
    """Posed vertex positions for a batch of frames.

    verts = LBS(v_template + shapedirs·betas + posedirs·(R(fullpose)-I)) + trans

    pose (N, pose_dof), betas (B',) shared by the batch or (N, B') per frame
    (the rest joints and shaped vertices then vary per frame, as under the
    JAX package's `vmap`), trans (N, 3) -> verts (N, V, 3) (and posed joints
    (N, J, 3) with `want_joints`).
    """
    J = model.num_joints
    nb = betas.shape[-1]
    fullpose = fullpose_from_pose(model, pose)
    N = fullpose.shape[0]
    rotmats = rodrigues(fullpose.reshape(N, J, 3))

    n = "n" if betas.dim() == 2 else ""    # per-frame or shared betas
    v_shaped = model.v_template + torch.einsum(
        f"vcb,{n}b->{n}vc", model.shapedirs[..., :nb], betas)
    joints = model.joint_template + torch.einsum(
        f"jcb,{n}b->{n}jc", model.joint_shapedirs[..., :nb], betas)

    if model.posedirs.shape[-1] and J > 1:
        eye = torch.eye(3, dtype=rotmats.dtype, device=rotmats.device)
        feat = (rotmats[:, 1:] - eye).reshape(N, -1)
        v_posed = v_shaped + torch.einsum("vcp,np->nvc", model.posedirs, feat)
    else:
        v_posed = v_shaped.expand(N, -1, -1)

    G_rot, G_tr = fk_globals(joints, rotmats, model.parents)
    A_tr = G_tr - torch.einsum(f"njab,{n}jb->nja", G_rot, joints)

    w = effective_weights(model)
    T_rot = torch.einsum("vj,njab->nvab", w, G_rot)
    T_tr = torch.einsum("vj,nja->nva", w, A_tr)
    verts = (torch.einsum("nvab,nvb->nva", T_rot, v_posed) + T_tr
             + trans[:, None, :])
    if want_joints:
        return verts, G_tr + trans[:, None, :]
    return verts
