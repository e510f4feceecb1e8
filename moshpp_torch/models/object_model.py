"""Rigid 6-DoF object model (port of `moshpp_tpu/models/object_model.py`;
reference `models/object_model.py:39-57`).

v = R(pose) @ v0 + trans, used to MoSh scanned rigid props (e.g. GRAB
objects) with the same solver as bodies.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from moshpp_torch.io.ply import read_ply
from moshpp_torch.models.body_model import SurfaceModel
from moshpp_torch.ops.rodrigues import rodrigues


@dataclasses.dataclass(frozen=True)
class RigidObjectModel:
    v_template: torch.Tensor  # (V, 3)
    faces: torch.Tensor       # (F, 3) int64

    @property
    def pose_dof(self) -> int:
        return 3

    def subset(self, vids) -> "RigidObjectModel":
        vids = torch.as_tensor(np.asarray(vids), dtype=torch.long,
                               device=self.v_template.device)
        return dataclasses.replace(self, v_template=self.v_template[vids])


def rigid_object_forward(model: RigidObjectModel, pose: torch.Tensor,
                         trans: torch.Tensor) -> torch.Tensor:
    """Posed object vertices (..., V, 3) from axis-angles pose (..., 3) and
    trans (..., 3). The reference right-multiplies (`v0 @ R`,
    object_model.py:50); this keeps the JAX package's `R @ v0`: the solved
    pose differs by a transpose, the fitted surface is the same."""
    rot = rodrigues(pose)
    return model.v_template @ rot.transpose(-1, -2) + trans[..., None, :]


def object_as_surface_model(obj: RigidObjectModel,
                            num_betas: int = 1) -> SurfaceModel:
    """The object as a one-joint `SurfaceModel` (rotation about the origin
    plus translation is the 6-DoF object model), so that the stage-ii solver
    and marker transport apply unchanged. Field for field the JAX package's
    embedding: zero shape directions, zero-width posedirs, unit weights on
    one root joint at the origin, no hands."""
    V = obj.v_template.shape[0]
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                   device=obj.v_template.device)
    return SurfaceModel(
        v_template=obj.v_template,
        shapedirs=z(V, 3, num_betas),
        posedirs=z(V, 3, 0),
        weights=torch.ones_like(z(V, 1)),
        joint_template=z(1, 3),
        joint_shapedirs=z(1, 3, num_betas),
        hands_components=z(0, 0),
        hands_mean=z(0),
        faces=obj.faces,
        model_type="object",
        parents=(-1,),
        num_betas=num_betas,
        dof_per_hand=0,
    )


def load_rigid_object(ply_fname: str, *, device) -> RigidObjectModel:
    """A scanned object mesh from a PLY file, on `device`
    (object_model.py:42-48)."""
    v, f = read_ply(ply_fname)
    return RigidObjectModel(
        v_template=torch.as_tensor(np.asarray(v, np.float32), device=device),
        faces=torch.as_tensor(np.asarray(f if f is not None
                                         else np.zeros((0, 3)), np.int64),
                              device=device))
