"""Simulated markers and their exact (trans, pose) Jacobian on the H100.

Port of `moshpp_tpu/ops/pallas_marker_jac.py` (E = 0: no extra shape dims).
The five Pallas marker kernels become two hand-written CUDA kernels, each
templated on whether it also emits the Jacobian chain:

  `fk_smalls`    csrc/fk_smalls.cu    replaces `_smalls_kernel` and
                                      `_sim_smalls_kernel`
  `marker_rows`  csrc/marker_rows.cu  replaces `_marker_kernel` and
                                      `_sim_marker_kernel`

Each wrapper dispatches on the device of its input: a CPU tensor runs the
plain PyTorch version (`ops/lbs_jacobian.py`), a CUDA tensor launches the
kernel or raises. The tables are dense and marker-major: the lane-banded,
16/8-row padded tables of the TPU kernels were Mosaic constraints.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from moshpp_torch import kernels
from moshpp_torch.models.body_model import (SurfaceModel, _ancestor_matrix,
                                            effective_weights, tree_depths)
from moshpp_torch.ops.lbs_jacobian import (JointSmalls, hand_chain,
                                           joint_smalls, reconstruct_with_grad,
                                           skin_rows)
from moshpp_torch.ops.marker_transform import MarkerFrameIndices

FK_JAC = "fk_smalls<jac>"
FK_SIM = "fk_smalls<sim>"
ROWS_JAC = "marker_rows<jac>"
ROWS_SIM = "marker_rows<sim>"
MAX_JOINTS = 64   # one thread a joint, ancestor sets as 64-bit masks


@dataclasses.dataclass(frozen=True)
class MarkerJacTables:
    """Problem-frozen tables of a (model, marker set, betas) problem."""
    parents: Tuple[int, ...]
    parents_t: torch.Tensor    # (J,) int32
    depth_t: torch.Tensor      # (J,) int32 tree depth, roots 0
    max_depth: int
    jnts: torch.Tensor         # (J, 3) shaped rest joints
    trel: torch.Tensor         # (J, 3) parent-relative rest joints
    anc: torch.Tensor          # (J, J) anc[k, j] = 1 iff j on root->k path
    ancmask: torch.Tensor      # (J,) int64 bit j of row k = anc[k, j]
    hc: Optional[torch.Tensor]  # (hand_dof, 3J - body_dof) hand-PCA components
    hands_mean: Optional[torch.Tensor]
    w3: torch.Tensor           # (M, 3, J) skinning weights of the frame verts
    s3: torch.Tensor           # (M, 3, J) w @ anc
    vsh3: torch.Tensor         # (M, 3, 3) shaped rest positions [m, k, c]
    pd3: torch.Tensor          # (M, 3, 3, featN) posedirs rows
    cf: torch.Tensor           # (M, 3) marker coefficients
    body_dof: int
    hand_dof: int

    @property
    def num_markers(self) -> int:
        return self.cf.shape[0]

    @property
    def num_joints(self) -> int:
        return len(self.parents)

    @property
    def feat_n(self) -> int:
        return self.pd3.shape[-1]

    @property
    def dof(self) -> int:
        return 3 + self.body_dof + self.hand_dof


def prepare_marker_jac_tables(model: SurfaceModel,
                              idx: MarkerFrameIndices,
                              coeffs: torch.Tensor,
                              betas: torch.Tensor) -> MarkerJacTables:
    """Freeze a (model, marker set, betas) problem into kernel tables, on
    the model's device. Shape sums run in float64 on the host, as in the JAX
    package."""
    parents = model.parents
    J = model.num_joints
    if J > MAX_JOINTS:
        raise ValueError(f"{J} joints: the marker kernels take <= {MAX_JOINTS}")
    dev = model.device
    nb = min(int(betas.shape[-1]), model.num_shape_dirs)
    betas64 = betas.detach().cpu().numpy().astype(np.float64)[:nb]
    has_pb = model.posedirs.shape[-1] > 0 and J > 1
    info = model.info
    hand_dof = model.pose_dof - info.body_pose_dof if info.has_hands else 0

    stacked = idx.stacked.cpu().numpy()                       # (M, 3)
    M = stacked.shape[0]
    inst = stacked.reshape(-1)

    w_eff = effective_weights(model).cpu().numpy()
    v_shaped = (model.v_template.cpu().numpy() + np.einsum(
        "vcb,b->vc", model.shapedirs.cpu().numpy()[..., :nb],
        betas64)).astype(np.float32)
    jnts = (model.joint_template.cpu().numpy() + np.einsum(
        "jcb,b->jc", model.joint_shapedirs.cpu().numpy()[..., :nb],
        betas64)).astype(np.float32)
    trel = jnts.copy()
    for j in range(J):
        if parents[j] >= 0:
            trel[j] = jnts[j] - jnts[parents[j]]
    anc = _ancestor_matrix(parents)
    bits = (anc.astype(np.uint64) << np.arange(J, dtype=np.uint64)).sum(
        axis=1, dtype=np.uint64)
    depth = tree_depths(parents)

    w_i = w_eff[inst]                                          # (3M, J)
    pd = (model.posedirs.cpu().numpy()[inst] if has_pb
          else np.zeros((3 * M, 3, 0), np.float32))
    t = lambda a, dt=torch.float32: torch.as_tensor(np.ascontiguousarray(a),
                                                    dtype=dt, device=dev)
    return MarkerJacTables(
        parents=parents,
        parents_t=t(np.asarray(parents), torch.int32),
        depth_t=t(np.asarray(depth), torch.int32),
        max_depth=max(depth),
        jnts=t(jnts),
        trel=t(trel),
        anc=t(anc),
        ancmask=t(bits.view(np.int64), torch.int64),
        hc=t(model.hands_components.cpu().numpy()) if hand_dof else None,
        hands_mean=t(model.hands_mean.cpu().numpy()) if hand_dof else None,
        w3=t(w_i.reshape(M, 3, J)),
        s3=t((w_i @ anc).reshape(M, 3, J)),
        vsh3=t(v_shaped[inst].reshape(M, 3, 3)),
        pd3=t(pd.reshape(M, 3, 3, -1)),
        cf=t(coeffs.detach().cpu().numpy()),
        body_dof=info.body_pose_dof,
        hand_dof=hand_dof,
    )


# ---- fk_smalls ---------------------------------------------------------------

def fk_smalls_plain(theta: torch.Tensor, tables: MarkerJacTables,
                    with_jac: bool) -> JointSmalls:
    """Plain PyTorch version of the `fk_smalls` kernel."""
    kernels.note_plain(FK_JAC if with_jac else FK_SIM, theta)
    return joint_smalls(theta, tables.jnts, tables.parents, with_jac)


def fk_smalls(theta: torch.Tensor, tables: MarkerJacTables,
              with_jac: bool) -> JointSmalls:
    """Per-frame joint quantities from fullpose axis-angles (F, J, 3)."""
    if not theta.is_cuda:
        return fk_smalls_plain(theta, tables, with_jac)
    F = theta.shape[0]
    J = tables.num_joints
    kernels.check("theta", theta, (F, J, 3))
    e = lambda *s: torch.empty(s, dtype=torch.float32, device=theta.device)
    sm = JointSmalls(grot=e(F, J, 3, 3), atr=e(F, J, 3),
                     feat=e(F, J - 1, 3, 3),
                     wrot=e(F, J, 3, 3, 3) if with_jac else None,
                     wtr=e(F, J, 3, 3) if with_jac else None,
                     dr=e(F, J, 3, 3, 3) if with_jac else None)
    p = kernels.ptr
    kernels.launch(
        "fk_smalls_launch", FK_JAC if with_jac else FK_SIM, int(with_jac),
        p(theta), p(tables.parents_t), p(tables.depth_t), tables.max_depth,
        p(tables.jnts), p(tables.trel), F, J, p(sm.grot), p(sm.atr),
        p(sm.feat), p(sm.wrot), p(sm.wtr), p(sm.dr))
    return sm


# ---- marker_rows -------------------------------------------------------------

def marker_rows_plain(sm: JointSmalls, trans: torch.Tensor,
                      tables: MarkerJacTables, with_jac: bool):
    """Plain PyTorch version of the `marker_rows` kernel: (sim (F, M, 3),
    jm (F, M, 3, D) or None)."""
    kernels.note_plain(ROWS_JAC if with_jac else ROWS_SIM, trans)
    F = trans.shape[0]
    M, J = tables.num_markers, tables.num_joints
    verts, Jfull = skin_rows(
        sm, tables.w3.reshape(3 * M, J), tables.s3.reshape(3 * M, J),
        tables.vsh3.reshape(3 * M, 3), tables.pd3.reshape(3 * M, 3, -1),
        tables.anc, trans, with_jac)
    # the local frame in float64, as the kernel computes it
    sim, dms = reconstruct_with_grad(verts.reshape(F, M, 3, 3),
                                     tables.cf.to(verts.dtype))
    sim, dms = sim.to(trans.dtype), dms.to(trans.dtype)
    if not with_jac:
        return sim, None
    # fold the marker frame into the columns first: 3 rows through the
    # hand-PCA product instead of 9 (the kernel's order)
    U = torch.einsum("fmkca,fmkaq->fmcq", dms,
                     Jfull.reshape(F, M, 3, 3, 3 * J))
    Jpose = hand_chain(U, tables.body_dof, tables.hc)
    eye = torch.eye(3, dtype=sim.dtype, device=sim.device)
    return sim, torch.cat([eye.expand(F, M, 3, 3), Jpose], dim=-1)


def marker_rows(sm: JointSmalls, trans: torch.Tensor,
                tables: MarkerJacTables, with_jac: bool):
    """Simulated markers (F, M, 3) and, with the Jacobian, jm (F, M, 3, D)."""
    if not trans.is_cuda:
        return marker_rows_plain(sm, trans, tables, with_jac)
    F = trans.shape[0]
    M, J, D = tables.num_markers, tables.num_joints, tables.dof
    kernels.check("trans", trans, (F, 3))
    kernels.check("grot", sm.grot, (F, J, 3, 3))
    kernels.check("atr", sm.atr, (F, J, 3))
    kernels.check("feat", sm.feat, (F, J - 1, 3, 3))
    if with_jac:
        kernels.check("wrot", sm.wrot, (F, J, 3, 3, 3))
        kernels.check("wtr", sm.wtr, (F, J, 3, 3))
        kernels.check("dr", sm.dr, (F, J, 3, 3, 3))
    sim = torch.empty((F, M, 3), dtype=torch.float32, device=trans.device)
    jm = (torch.empty((F, M, 3, D), dtype=torch.float32, device=trans.device)
          if with_jac else None)
    p = kernels.ptr
    kernels.launch(
        "marker_rows_launch", ROWS_JAC if with_jac else ROWS_SIM,
        int(with_jac), F, M, J, tables.feat_n, tables.body_dof,
        tables.hand_dof, D, p(sm.grot), p(sm.atr), p(sm.feat), p(sm.wrot),
        p(sm.wtr), p(sm.dr), p(trans), p(tables.w3), p(tables.s3),
        p(tables.vsh3), p(tables.pd3), p(tables.cf), p(tables.ancmask),
        p(tables.hc), p(sim), p(jm))
    return sim, jm


# ---- public entry points -----------------------------------------------------

def _theta_trans(model: SurfaceModel, tables: MarkerJacTables,
                 x: torch.Tensor):
    """Fullpose axis-angles (F, J, 3) and translations (F, 3) of packed
    (trans, pose) rows; the hand-PCA product stays a plain matmul, as it
    stays outside the Pallas kernels."""
    P = model.pose_dof
    if x.shape[-1] != 3 + P:
        raise NotImplementedError(
            f"x has {x.shape[-1]} columns, expected 3 + {P}: extra shape "
            "dims (DMPL, expressions) are not ported yet")
    x = x.to(torch.float32)
    trans = x[:, :3].contiguous()
    pose = x[:, 3:]
    if tables.hc is not None:
        bd = tables.body_dof
        hands = tables.hands_mean + pose[:, bd:] @ tables.hc
        pose = torch.cat([pose[:, :bd], hands], dim=1)
    return pose.reshape(x.shape[0], -1, 3).contiguous(), trans


def marker_sim_and_jacobian(model: SurfaceModel, tables: MarkerJacTables,
                            x: torch.Tensor):
    """x (F, 3+P) -> (sim (F, M, 3), jm (F, M, 3, 3+P))."""
    theta, trans = _theta_trans(model, tables, x)
    return marker_rows(fk_smalls(theta, tables, True), trans, tables, True)


def marker_sim(model: SurfaceModel, tables: MarkerJacTables,
               x: torch.Tensor) -> torch.Tensor:
    """x (F, 3+P) -> simulated markers (F, M, 3), no derivative chain."""
    theta, trans = _theta_trans(model, tables, x)
    return marker_rows(fk_smalls(theta, tables, False), trans, tables,
                       False)[0]
