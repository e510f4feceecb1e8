"""Closed-form LBS/marker Jacobians for the frozen-shape (stage-ii) solve.

Port of `moshpp_tpu/ops/lbs_jacobian.py`, batched over frames, in the two
stages the marker kernels split it into:

  `joint_smalls`  per frame and joint: R(theta) and dR/dtheta, global
                  transforms G over the tree, skinning translations
                  A_tr = G_tr - G_rot j, path generators
                  W_j = G_p(j) (dL_j L_j^-1) G_p(j)^-1, pose-blend features;
  `skin_rows`     per frame and vertex: the posed position and its
                  full-pose Jacobian J[v, :, (j,t)] = Wrot_{j,t} S_vj
                  + s_vj Wtr_{j,t} + T_rot d(v_posed)/dtheta_{j,t}, with
                  S_vj = sum_k w_vk anc_kj (A_k v_posed) and s = w @ anc.

With more extra shape dims than the inline kernels take, the tiled route
splits the extras off both stages: `extras_tangent_rows` and
`extras_cols_rows` compute the E Jacobian columns from the stages' outputs.
These are the plain versions of the Hopper marker kernels
(`ops/marker_jac.py`), whose outputs use the same tensors and layouts.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from moshpp_torch.models.body_model import (SurfaceModel, _ancestor_matrix,
                                            effective_weights, fk_globals,
                                            fullpose_from_pose, rel_trans)
from moshpp_torch.ops.marker_transform import MarkerFrameIndices
from moshpp_torch.ops.rodrigues import rodrigues, rodrigues_with_grad

_EPS = 1e-12


class JointSmalls(NamedTuple):
    """Per-frame, per-joint quantities, frame-major and contiguous.

    grot (F, J, 3, 3), atr (F, J, 3), feat (F, J-1, 3, 3) = R - I of the
    non-root joints; with the Jacobian also wrot (F, J, 3, 3, 3) [a, d, t],
    wtr (F, J, 3, 3) [a, t] and dr (F, J, 3, 3, 3) [a, b, t]; with the
    Jacobian and E extra shape dims also datr (F, E, J, 3) = dA_tr/dx_e;
    on the tiled extras route, with the Jacobian, q (F, J, 3, 3) = the
    parent's global rotation (identity at a root) in place of datr."""
    grot: torch.Tensor
    atr: torch.Tensor
    feat: torch.Tensor
    wrot: Optional[torch.Tensor] = None
    wtr: Optional[torch.Tensor] = None
    dr: Optional[torch.Tensor] = None
    datr: Optional[torch.Tensor] = None
    q: Optional[torch.Tensor] = None


def joint_smalls(theta: torch.Tensor, jnts: torch.Tensor,
                 parents: Tuple[int, ...], with_jac: bool,
                 extra: Optional[torch.Tensor] = None,
                 djnt: Optional[torch.Tensor] = None,
                 dtrel: Optional[torch.Tensor] = None,
                 emit_q: bool = False) -> JointSmalls:
    """theta (F, J, 3) fullpose axis-angles, jnts (J, 3) shaped rest joints
    or (F, J, 3) per frame (the tiled route's shifted rest joints).

    With extra shape dims, extra (F, E) shifts the rest joints per frame
    along djnt (J, E, 3), as the JAX kernels' `_frame_rest_geometry`; with
    the Jacobian, datr is emitted in the closed form of `_smalls_impl`
    (`extras_tangent_rows`). With the Jacobian and `emit_q`, q is emitted."""
    F, J, _ = theta.shape
    if with_jac:
        R, dR = rodrigues_with_grad(theta)
    else:
        R, dR = rodrigues(theta), None
    if extra is not None:
        jnts = jnts + torch.einsum("fe,jec->fjc", extra, djnt)
    f = "f" if jnts.dim() == 3 else ""     # per-frame or shared rest joints
    G_rot, G_tr = fk_globals(jnts, R, parents)
    A_tr = G_tr - torch.einsum(f"fjab,{f}jb->fja", G_rot, jnts)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    feat = (R[:, 1:] - eye).contiguous()
    if not with_jac:
        return JointSmalls(G_rot.contiguous(), A_tr.contiguous(), feat)

    t_rel = rel_trans(jnts, parents)
    pidx = torch.as_tensor([max(p, 0) for p in parents], device=R.device)
    root = torch.as_tensor([p < 0 for p in parents], device=R.device)
    Q = torch.where(root[:, None, None], eye, G_rot[:, pidx])
    b = torch.where(root[:, None], torch.zeros_like(G_tr), G_tr[:, pidx])
    dRRt = torch.einsum("fjabt,fjcb->fjact", dR, R)
    u = -torch.einsum(f"fjabt,{f}jb->fjat", dRRt, t_rel)
    W_rot = torch.einsum("fjab,fjbct,fjdc->fjadt", Q, dRRt, Q)
    W_tr = (-torch.einsum("fjabt,fjb->fjat", W_rot, b)
            + torch.einsum("fjab,fjbt->fjat", Q, u))
    datr = None
    if extra is not None:
        anc = torch.as_tensor(_ancestor_matrix(parents), device=R.device)
        datr = extras_tangent_rows(Q, G_rot, anc, dtrel, djnt)
    return JointSmalls(G_rot.contiguous(), A_tr.contiguous(), feat,
                       W_rot.contiguous(), W_tr.contiguous(), dR.contiguous(),
                       datr, Q.contiguous() if emit_q else None)


def extras_tangent_rows(Q: torch.Tensor, G_rot: torch.Tensor,
                        anc: torch.Tensor, dtrel: torch.Tensor,
                        djnt: torch.Tensor) -> torch.Tensor:
    """datr (F, E, J, 3) = dA_tr/dx_e: G_tr is linear in the rest offsets,
    so dA_tr_e[j] = sum over k on the root->j path of Q_k dtrel_e[k], minus
    G_rot[j] djnt_e[j]; Q (F, J, 3, 3) parent global rotations (identity at
    a root), anc (J, J) ancestor mask, dtrel/djnt (J, E, 3)."""
    dG = torch.einsum("jk,fkab,keb->feja", anc, Q, dtrel)
    return (dG - torch.einsum("fjab,jeb->feja", G_rot, djnt)).contiguous()


def skin_rows(sm: JointSmalls, w: torch.Tensor, s: torch.Tensor,
              vsh: torch.Tensor, pd: torch.Tensor, anc: torch.Tensor,
              trans: torch.Tensor, with_jac: bool,
              extra: Optional[torch.Tensor] = None,
              dv: Optional[torch.Tensor] = None,
              vshift: Optional[torch.Tensor] = None):
    """Posed vertices (F, I, 3), in float64, and with the Jacobian their
    float32 full-pose Jacobian (F, I, 3, 3J) for I vertex rows and, with
    extra shape dims, their E extra columns (F, I, 3, E) (else None).

    w, s (I, J) skinning weights and w @ anc; vsh (I, 3) shaped rest
    positions; pd (I, 3, 9(J-1)) posedirs rows (width 0 without pose
    blends); anc (J, J) ancestor mask; trans (F, 3); extra (F, E) shifts the
    rest positions along dv (I, E, 3), and the extra columns are
    sum_j w_j datr_e[j] + T_rot dv_e (`_marker_impl`). The tiled route
    passes the shift itself, vshift (F, I, 3), and gets no extra columns.

    The positions are summed in float64 from the float32 inputs: a marker's
    local frame can be nearly degenerate, and its derivative then amplifies
    float32 rounding of the positions (the marker kernel does the same)."""
    F, J = sm.grot.shape[:2]
    I = w.shape[0]
    featN = pd.shape[-1]
    f64 = torch.float64
    vp64 = vsh.to(f64).expand(F, I, 3)
    if featN:
        vp64 = vp64 + torch.einsum("icp,fp->fic", pd.to(f64),
                                   sm.feat.reshape(F, featN).to(f64))
    if extra is not None:
        vp64 = vp64 + torch.einsum("iec,fe->fic", dv.to(f64), extra.to(f64))
    if vshift is not None:
        vp64 = vp64 + vshift.to(f64)
    w64 = w.to(f64)
    T_rot64 = torch.einsum("ij,fjac->fiac", w64, sm.grot.to(f64))
    T_tr64 = torch.einsum("ij,fja->fia", w64, sm.atr.to(f64))
    verts = (torch.einsum("fiac,fic->fia", T_rot64, vp64) + T_tr64
             + trans[:, None, :].to(f64))
    if not with_jac:
        return verts, None, None
    vp, T_rot = vp64.to(w.dtype), T_rot64.to(w.dtype)
    Je = None
    if extra is not None:
        Je = (torch.einsum("ij,feja->fiae", w, sm.datr)
              + torch.einsum("fiac,iec->fiae", T_rot, dv))
    z = torch.einsum("fjbc,fic->fijb", sm.grot, vp) + sm.atr[:, None]
    S = torch.einsum("fikb,kj->fijb", w[None, :, :, None] * z, anc)
    Jf = (torch.einsum("fjabt,fijb->fiajt", sm.wrot, S)
          + torch.einsum("ij,fjat->fiajt", s, sm.wtr))
    if featN:
        dvp = torch.einsum("icjab,fjabt->ficjt", pd.reshape(I, 3, J - 1, 3, 3),
                           sm.dr[:, 1:])
        Jf[:, :, :, 1:, :] += torch.einsum("fiac,ficjt->fiajt", T_rot, dvp)
    return verts, Jf.reshape(F, I, 3, 3 * J), Je


def extras_cols_rows(datr: torch.Tensor, uv: torch.Tensor, w3: torch.Tensor,
                     dv: torch.Tensor) -> torch.Tensor:
    """The E extra columns (F, M, 3, E) of the tiled route
    (`_extras_cols_kernel`): jm[c, e] = sum_k [sum_d U_k[c][d] (w_k .
    datr_e)[d] + sum_z V_k[c][z] dv_e[k][z]], with uv (F, M, 54) the marker
    rows' chain factors U = dms [k][c][d] and V = dms T_rot [k][c][z],
    w3 (M, 3, J) skinning weights, dv (M, 3, E, 3) vertex directions."""
    F, M = uv.shape[:2]
    J = w3.shape[-1]
    E = datr.shape[1]
    wdat = torch.matmul(w3.reshape(3 * M, J),
                        datr.permute(0, 2, 1, 3).reshape(F, J, 3 * E))
    U = uv[..., :27].reshape(F, M, 3, 3, 3)
    V = uv[..., 27:].reshape(F, M, 3, 3, 3)
    return (torch.einsum("fmkcd,fmked->fmce", U,
                         wdat.reshape(F, M, 3, E, 3))
            + torch.einsum("fmkcz,mkez->fmce", V, dv))


def _skew(v: torch.Tensor) -> torch.Tensor:
    """[v]x (..., 3, 3) of vectors (..., 3)."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def reconstruct_with_grad(tri: torch.Tensor, cf: torch.Tensor):
    """Markers from their frame-vertex triples and the exact derivative.

    tri (..., M, 3 verts, 3), cf (M, 3) -> (sim (..., M, 3),
    dms (..., M, 3 verts, 3, 3)) with dms[..., k, c, d] = d sim_c / d v_kd,
    the hand-derived blocks of the eps-guarded normalizations
    (`pallas_marker_jac._marker_impl`)."""
    v0, v1, v2 = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    c1, c2, c3 = cf[:, 0:1], cf[:, 1:2], cf[:, 2:3]
    e1 = v1 - v0
    e2 = v2 - v0
    n1 = torch.sqrt(torch.sum(e1 * e1, -1, keepdim=True) + _EPS)
    f1 = e1 / n1
    cz = torch.linalg.cross(e1, e2)
    n2 = torch.sqrt(torch.sum(cz * cz, -1, keepdim=True) + _EPS)
    f2 = cz / n2
    f3 = torch.linalg.cross(f1, f2)
    sim = v0 + c1 * f1 + c2 * f2 + c3 * f3
    eye = torch.eye(3, dtype=tri.dtype, device=tri.device)
    M1 = (eye - f1[..., :, None] * f1[..., None, :]) / n1[..., None]
    M2 = (eye - f2[..., :, None] * f2[..., None, :]) / n2[..., None]
    A1 = M2 @ (-_skew(e2))
    A2 = M2 @ _skew(e1)
    S1 = _skew(f1)
    B1 = S1 @ A1
    B2 = S1 @ A2
    N1 = _skew(f2) @ M1
    c1, c2, c3 = c1[..., None], c2[..., None], c3[..., None]
    dm1 = c1 * M1 + c2 * A1 + c3 * (B1 - N1)
    dm2 = c2 * A2 + c3 * B2
    dm0 = eye - dm1 - dm2
    return sim, torch.stack([dm0, dm1, dm2], dim=-3)


def hand_chain(Jfull: torch.Tensor, body_dof: int,
               hc: Optional[torch.Tensor]) -> torch.Tensor:
    """Full-pose columns (..., 3J) -> optimization-pose columns (..., P):
    the hand-PCA tail goes through the components."""
    if hc is None:
        return Jfull
    return torch.cat([Jfull[..., :body_dof], Jfull[..., body_dof:] @ hc.T],
                     dim=-1)


class VertsAndJacobian(NamedTuple):
    verts: torch.Tensor   # (F, V, 3) posed vertices
    jac: torch.Tensor     # (F, V, 3, 3 + pose_dof) d verts / d (trans, pose)


def lbs_verts_and_jacobian(model: SurfaceModel,
                           pose: torch.Tensor,
                           betas: torch.Tensor,
                           trans: torch.Tensor) -> VertsAndJacobian:
    """Posed vertices and their (trans, pose) Jacobian for a batch of frames
    (pose (F, P), betas (B,), trans (F, 3)); betas are constants."""
    parents = model.parents
    J = model.num_joints
    F = pose.shape[0]
    nb = betas.shape[-1]
    theta = fullpose_from_pose(model, pose).reshape(F, J, 3)
    v_shaped = model.v_template + torch.einsum(
        "vcb,b->vc", model.shapedirs[..., :nb], betas)
    joints = model.joint_template + torch.einsum(
        "jcb,b->jc", model.joint_shapedirs[..., :nb], betas)
    sm = joint_smalls(theta, joints, parents, with_jac=True)
    w = effective_weights(model)
    anc = torch.as_tensor(_ancestor_matrix(parents), device=w.device)
    pd = model.posedirs if J > 1 else model.posedirs[..., :0]
    verts, Jfull, _ = skin_rows(sm, w, w @ anc, v_shaped, pd, anc, trans,
                                True)
    hc = model.hands_components if model.info.has_hands else None
    Jpose = hand_chain(Jfull, model.info.body_pose_dof, hc)
    V = verts.shape[1]
    eye = torch.eye(3, dtype=Jpose.dtype, device=Jpose.device)
    jac = torch.cat([eye.expand(F, V, 3, 3), Jpose], dim=-1)
    return VertsAndJacobian(verts=verts.to(Jpose.dtype), jac=jac)


def markers_and_jacobian(verts: torch.Tensor,
                         jac_verts: torch.Tensor,
                         idx: MarkerFrameIndices,
                         coeffs: torch.Tensor):
    """Simulated markers (F, M, 3) and d markers / d x (F, M, 3, D) from
    posed vertices (F, V, 3) and their Jacobian (F, V, 3, D)."""
    st = idx.stacked
    sim, dms = reconstruct_with_grad(verts[:, st], coeffs)
    Jm = torch.einsum("fmkcd,fmkdp->fmcp", dms, jac_verts[:, st])
    return sim, Jm
