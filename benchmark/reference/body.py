"""Plain SMPL-family forward model: linear blend skinning with pose and
shape blend shapes and a hand-PCA pose space, in float64 by default.

Written from the published model (Loper et al., "SMPL", 2015; Romero et
al., "Embodied Hands", 2017; Pavlakos et al., "SMPL-X", 2019), and from the
arrays of a model file as they are on disk: `v_template`, `shapedirs`,
`posedirs`, `weights`, `J_regressor`, `kintree_table`, and the hand PCA
(`componentsl/r`, `hands_meanl/r`). Nothing here reads what the program
under test derived from those files.

The `precision` of a `Body` names the arithmetic of every product: "float64", "float32" or
"tf32" (float32 with every product's operands rounded to TF32's 10-bit
mantissa first, the precision a float32 matmul takes on the tensor cores;
done by rounding, so it reads the same on any device).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

PRECISIONS = ("float64", "float32", "tf32")


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 `t` rounded to the nearest value with a 10-bit mantissa
    (TF32), ties away from zero, as the tensor cores read their operands."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class Arith:
    """The products of one precision: `einsum` and `matmul` that round their
    operands to TF32 when asked."""

    def __init__(self, precision: str):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" else torch.float32

    def _ops(self, ops):
        if self.precision != "tf32":
            return ops
        return [round_tf32(o) for o in ops]

    def einsum(self, eq: str, *ops) -> torch.Tensor:
        return torch.einsum(eq, *self._ops(ops))

    def matmul(self, a, b) -> torch.Tensor:
        a, b = self._ops((a, b))
        return a @ b


def rodrigues(r: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3):
    R = I + (sin t / t) K + ((1 - cos t) / t^2) K^2, K the cross-product
    matrix of r, with the series of both factors below t = 1e-4."""
    t2 = torch.sum(r * r, dim=-1)
    t = torch.sqrt(t2)
    small = t < 1e-4
    ts = torch.where(small, torch.ones_like(t), t)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(ts) / ts)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(ts)) / (ts * ts))
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    o = torch.zeros_like(x)
    K = torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1).reshape(
        r.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


@dataclasses.dataclass
class Body:
    """One model's arrays on a device in the reference's precision, with the
    rest joints regressed from the shaped mesh (joints = J_regressor @
    (v_template + shapedirs . coefficients))."""
    v_template: torch.Tensor      # (V, 3)
    shapedirs: torch.Tensor       # (V, 3, S)
    posedirs: torch.Tensor        # (V, 3, 9 (J - 1))
    weights: torch.Tensor         # (V, J)
    joint_template: torch.Tensor  # (J, 3) = J_regressor @ v_template
    joint_dirs: torch.Tensor      # (J, 3, S) = J_regressor @ shapedirs
    hand_comps: Optional[torch.Tensor]   # (hand_dof, 3 * hand joints)
    hand_mean: Optional[torch.Tensor]    # (3 * hand joints,)
    parents: Sequence[int]
    body_pose_dof: int            # axis-angle dofs before the hand PCA
    arith: Arith

    @classmethod
    def from_files(cls, model: dict, hands: Optional[dict], *,
                   body_pose_dof: int, dof_per_hand: int,
                   use_hands_mean: bool, device,
                   precision: str = "float64") -> "Body":
        """From the model file's arrays (`model`: v_template, shapedirs,
        posedirs, weights, J_regressor, kintree_table) and the hand-PCA
        file's (`hands`: componentsl/r, hands_meanl/r), as numpy arrays."""
        ar = Arith(precision)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                      device=device).to(ar.dtype)
        jreg = t(model["J_regressor"])
        vt, sd = t(model["v_template"]), t(model["shapedirs"])
        parents = [int(p) if p < 2 ** 31 else -1
                   for p in np.asarray(model["kintree_table"])[0]]
        hc = hm = None
        if hands is not None:
            cl = np.asarray(hands["componentsl"], np.float64)[:dof_per_hand]
            cr = np.asarray(hands["componentsr"], np.float64)[:dof_per_hand]
            z = np.zeros_like(cl)
            hc = t(np.block([[cl, z], [np.zeros_like(cr), cr]]))
            mean = np.concatenate([np.asarray(hands["hands_meanl"]),
                                   np.asarray(hands["hands_meanr"])])
            hm = t(mean if use_hands_mean else np.zeros_like(mean))
        return cls(v_template=vt, shapedirs=sd, posedirs=t(model["posedirs"]),
                   weights=t(model["weights"]),
                   joint_template=ar.matmul(jreg, vt),
                   joint_dirs=ar.einsum("jv,vcs->jcs", jreg, sd),
                   hand_comps=hc, hand_mean=hm, parents=parents,
                   body_pose_dof=body_pose_dof, arith=ar)

    @property
    def num_joints(self) -> int:
        return len(self.parents)

    @property
    def dtype(self):
        return self.arith.dtype

    def fullpose(self, pose: torch.Tensor) -> torch.Tensor:
        """(N, P) pose vectors -> (N, 3 J) axis-angles: the body dofs, then
        the hands as hand_mean + coefficients @ components."""
        pose = pose.to(self.dtype)
        if self.hand_comps is None:
            return pose
        bd = self.body_pose_dof
        hands = self.hand_mean + self.arith.matmul(pose[:, bd:],
                                                   self.hand_comps)
        return torch.cat([pose[:, :bd], hands], dim=1)

    def forward(self, pose: torch.Tensor, trans: torch.Tensor,
                coeffs: torch.Tensor, cols: Sequence[int],
                vids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Posed vertices (N, V', 3) of vertices `vids` (all if None).

        pose (N, P), trans (N, 3); coeffs (C,) shared or (N, C) per frame,
        the coefficients of shapedirs columns `cols` (the betas, and per
        frame the expressions or DMPLs in their own columns)."""
        ar = self.arith
        N = pose.shape[0]
        J = self.num_joints
        coeffs = coeffs.to(self.dtype)
        if coeffs.dim() == 1:
            coeffs = coeffs.expand(N, -1)
        idx = torch.as_tensor(list(cols), device=self.v_template.device)
        vdirs, jdirs = self.shapedirs[..., idx], self.joint_dirs[..., idx]
        vt, pd, w = self.v_template, self.posedirs, self.weights
        if vids is not None:
            vt, pd, w, vdirs = vt[vids], pd[vids], w[vids], vdirs[vids]
        R = rodrigues(self.fullpose(pose).reshape(N, J, 3))
        v = vt + ar.einsum("vcs,ns->nvc", vdirs, coeffs)
        joints = self.joint_template + ar.einsum("jcs,ns->njc", jdirs, coeffs)
        eye = torch.eye(3, dtype=self.dtype, device=R.device)
        feat = (R[:, 1:] - eye).reshape(N, -1)
        v = v + ar.einsum("vcp,np->nvc", pd, feat)
        g_rot = [None] * J
        g_tr = [None] * J
        for j, p in enumerate(self.parents):
            if p < 0:
                g_rot[j], g_tr[j] = R[:, j], joints[:, j]
                continue
            g_rot[j] = ar.matmul(g_rot[p], R[:, j])
            g_tr[j] = g_tr[p] + ar.einsum("nab,nb->na", g_rot[p],
                                          joints[:, j] - joints[:, p])
        G = torch.stack(g_rot, dim=1)                     # (N, J, 3, 3)
        A = torch.stack(g_tr, dim=1) - ar.einsum("njab,njb->nja", G, joints)
        T = ar.einsum("vj,njab->nvab", w, G)
        return (ar.einsum("nvab,nvb->nva", T, v)
                + ar.einsum("vj,nja->nva", w, A) + trans.to(self.dtype)[:, None])

    def body_vertices(self) -> torch.Tensor:
        """(V,) bool: vertices whose dominant joint is below 1 +
        body_pose_dof // 3 (the body-vertex rule of the v2v metric)."""
        return torch.argmax(self.weights, dim=1) < 1 + self.body_pose_dof // 3
