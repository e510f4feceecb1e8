"""Simulated markers and their exact (trans, pose, extras) Jacobian on the
H100.

Port of `moshpp_tpu/ops/pallas_marker_jac.py`. The Pallas marker kernels
become hand-written CUDA kernels; the two stages are templated on whether
they also emit the Jacobian chain and on how the problem's extra shape dims
(DMPL soft-tissue coefficients or expressions riding shapedirs columns)
enter:

  `fk_smalls`       csrc/fk_smalls.cu       `_smalls_kernel`, `_sim_smalls_kernel`;
                                            `<.,ext>` `_smalls_kernel_ext`,
                                            `_sim_smalls_kernel_ext`;
                                            `<.,tiled>` `_smalls_kernel_tiled`,
                                            `_sim_smalls_kernel_tiled`
  `marker_rows`     csrc/marker_rows.cu     `_marker_kernel`, `_sim_marker_kernel`;
                                            `<.,ext>` `_marker_kernel_ext`,
                                            `_sim_marker_kernel_ext`;
                                            `<.,tiled>` `_marker_kernel_tiled`,
                                            `_sim_marker_kernel_tiled`;
                                            `<jac[,..],fold>`
                                            `_marker_jac_w_kernel`,
                                            `_marker_jac_w_kernel_ext`,
                                            `_marker_jac_w_kernel_tiled`
  `extras_tangent`  csrc/extras_tangent.cu  `_extras_tangent_kernel`
  `extras_cols`     csrc/extras_cols.cu     `_extras_cols_kernel`

Up to `MAX_INLINE_EXTRAS` extra dims ride inline (`<.,ext>`); wider blocks
take the JAX package's tiled route: the per-frame shifts of the rest
geometry are two matmuls here (`extra_shifts`), the two stages run on the
shifted geometry (`<.,tiled>`, programs free of E), and two more kernels
compute the E extra columns, which `extras_cols` writes into jm's last E
columns in place.

`marker_resid_and_wjac` is the folded-weights entry point (the stage-ii
system's `fold_weights`): the `<jac,..,fold>` marker rows also read the
observations and the data weights and write the weighted residual and the
weighted Jacobian, so the system skips its (F, M, 3, D) weighting pass.

Each wrapper dispatches on the device of its input: a CPU tensor runs the
plain PyTorch version (`ops/lbs_jacobian.py`), a CUDA tensor launches the
kernel or raises. The tables are dense and marker-major: the lane-banded,
16/8-row padded tables of the TPU kernels were Mosaic constraints.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from moshpp_torch import kernels
from moshpp_torch.models.body_model import (SurfaceModel, _ancestor_matrix,
                                            effective_weights)
from moshpp_torch.ops.lbs_jacobian import (JointSmalls, extras_cols_rows,
                                           extras_tangent_rows, hand_chain,
                                           joint_smalls, reconstruct_with_grad,
                                           skin_rows)
from moshpp_torch.ops.marker_transform import MarkerFrameIndices

MAX_JOINTS = 64   # one thread a joint, ancestor sets as 64-bit masks
# widest extras block the inline kernels take (the JAX package's
# INLINE_MAX_EXTRAS); wider ones take the tiled route
MAX_INLINE_EXTRAS = 16
UV_WIDTH = 54     # the marker rows' chain factors U (27) and V (27)


def _names(with_jac: bool, route: str = "", fold: bool = False):
    """(fk_smalls, marker_rows) counter names of one variant; route "" (no
    extras), "ext" (inline extras) or "tiled"; `fold` names the folded
    marker rows (whose fk_smalls is the unfolded one's)."""
    tag = ("jac" if with_jac else "sim") + (f",{route}" if route else "")
    return f"fk_smalls<{tag}>", f"marker_rows<{tag}{',fold' if fold else ''}>"


FK_JAC, ROWS_JAC = _names(True)
FK_SIM, ROWS_SIM = _names(False)
FK_JAC_EXT, ROWS_JAC_EXT = _names(True, "ext")
FK_SIM_EXT, ROWS_SIM_EXT = _names(False, "ext")
FK_JAC_TILED, ROWS_JAC_TILED = _names(True, "tiled")
FK_SIM_TILED, ROWS_SIM_TILED = _names(False, "tiled")
ROWS_JAC_FOLD = _names(True, fold=True)[1]
ROWS_JAC_EXT_FOLD = _names(True, "ext", True)[1]
ROWS_JAC_TILED_FOLD = _names(True, "tiled", True)[1]
TANGENT = "extras_tangent"
COLS = "extras_cols"


@dataclasses.dataclass(frozen=True)
class MarkerJacTables:
    """Problem-frozen tables of a (model, marker set, betas) problem."""
    parents: Tuple[int, ...]
    parents_t: torch.Tensor    # (J,) int32
    jnts: torch.Tensor         # (J, 3) shaped rest joints
    trel: torch.Tensor         # (J, 3) parent-relative rest joints
    anc: torch.Tensor          # (J, J) anc[k, j] = 1 iff j on root->k path
    ancmask: torch.Tensor      # (J,) int64 bit j of row k = anc[k, j]
    hc: Optional[torch.Tensor]  # (hand_dof, 3J - body_dof) hand-PCA components
    hands_mean: Optional[torch.Tensor]
    w3: torch.Tensor           # (M, 3, J) skinning weights of the frame verts
    # w3's nonzero weights as lists, ascending joints, zero-padded to the
    # largest count K (extras_cols loops over K, not J)
    wnz_j: torch.Tensor        # (M, 3, K) int32 joint of each weight
    wnz_w: torch.Tensor        # (M, 3, K) float32 the weight (0 as padding)
    s3: torch.Tensor           # (M, 3, J) w @ anc
    vsh3: torch.Tensor         # (M, 3, 3) shaped rest positions [m, k, c]
    # the posedirs rows joint-last, [m, k, c, ab, j - 1] = posedirs row
    # (m, k, c) at feature 9 (j - 1) + ab: the marker_rows kernels read them
    # coalesced over joints
    pdt: torch.Tensor          # (M, 3, 3, 9, J - 1), or (M, 3, 3, 0) empty
    pd64: torch.Tensor         # pdt in float64, for the float64 pose blend
    cf: torch.Tensor           # (M, 3) marker coefficients
    body_dof: int
    hand_dof: int
    # diagonal blocks of hc the marker_rows kernels multiply by, one a hand
    # when hc is block-diagonal by hand, else 1 (the full product)
    hand_blocks: int
    # extra shape dims: E direction columns of joint_shapedirs / shapedirs
    # (E = 0: zero-width tables)
    djnt: torch.Tensor         # (J, E, 3) rest-joint directions
    dtrel: torch.Tensor        # (J, E, 3) parent-relative directions
    dv: torch.Tensor           # (M, 3, E, 3) frame-vertex directions [m, k, e, c]
    dvt: torch.Tensor          # (M, 3, 3, E) the same, extra dims last
    # the same directions laid out for the tiled route's shift matmuls
    jdirs: torch.Tensor        # (E, 2 * J * 3) rows [dtrel_e; djnt_e]
    vdirs: torch.Tensor        # (E, M * 9) rows dv_e [m, k, c]

    @property
    def num_markers(self) -> int:
        return self.cf.shape[0]

    @property
    def num_joints(self) -> int:
        return len(self.parents)

    @property
    def feat_n(self) -> int:
        return 9 * self.pdt.shape[-1] if self.pdt.dim() == 5 else 0

    @property
    def pd3(self) -> torch.Tensor:
        """The posedirs rows in feature order, (M, 3, 3, featN)."""
        M = self.num_markers
        return self.pdt.transpose(-1, -2).reshape(M, 3, 3, self.feat_n)

    @property
    def n_extra(self) -> int:
        return self.djnt.shape[1]

    @property
    def dof(self) -> int:
        return 3 + self.body_dof + self.hand_dof + self.n_extra

    @property
    def route(self) -> str:
        """The kernels' extras route: "" (none), "ext" (inline) or
        "tiled"."""
        E = self.n_extra
        return "" if E == 0 else ("ext" if E <= MAX_INLINE_EXTRAS else "tiled")


def prepare_marker_jac_tables(model: SurfaceModel,
                              idx: MarkerFrameIndices,
                              coeffs: torch.Tensor,
                              betas: torch.Tensor,
                              extra_cols=None) -> MarkerJacTables:
    """Freeze a (model, marker set, betas) problem into kernel tables, on
    the model's device. Shape sums run in float64 on the host, as in the JAX
    package.

    extra_cols: optional column indices into shapedirs / joint_shapedirs of
    per-frame extra shape dims (the DMPL columns [num_betas,
    num_betas + num_dmpls), or expression columns); the kernels then shift
    the rest geometry per frame and emit E extra Jacobian columns."""
    parents = model.parents
    J = model.num_joints
    if J > MAX_JOINTS:
        raise ValueError(f"{J} joints: the marker kernels take <= {MAX_JOINTS}")
    if any(p >= j for j, p in enumerate(parents)):
        raise ValueError(f"parents {tuple(parents)}: the kernels' tree scans "
                         f"need every parent before its children")
    cols = np.asarray([] if extra_cols is None else extra_cols, np.int64)
    E = len(cols)
    if E and int(cols.max()) >= model.num_shape_dirs:
        raise ValueError(f"extra column {int(cols.max())} beyond shapedirs "
                         f"width {model.num_shape_dirs}")
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

    w_i = w_eff[inst]                                          # (3M, J)
    wnz_j, wnz_w = sparse_weights(w_i)
    pd = (model.posedirs.cpu().numpy()[inst] if has_pb
          else np.zeros((3 * M, 3, 0), np.float32))
    featN = pd.shape[-1]
    if featN not in (0, 9 * (J - 1)):
        raise ValueError(f"posedirs width {featN}: the kernels take "
                         f"9 (J - 1) = {9 * (J - 1)} features or none")
    pdt = (pd.reshape(M, 3, 3, J - 1, 9).transpose(0, 1, 2, 4, 3)
           if featN else pd.reshape(M, 3, 3, 0))
    hc = model.hands_components.cpu().numpy() if hand_dof else None
    djnt = model.joint_shapedirs.cpu().numpy().astype(np.float64)[
        ..., cols].transpose(0, 2, 1)                          # (J, E, 3)
    dtrel = djnt.copy()
    for j in range(J):
        if parents[j] >= 0:
            dtrel[j] = djnt[j] - djnt[parents[j]]
    dv = model.shapedirs.cpu().numpy()[inst][..., cols].reshape(
        M, 3, 3, E).transpose(0, 1, 3, 2)                      # [m, k, e, c]
    t = lambda a, dt=torch.float32: torch.as_tensor(np.ascontiguousarray(a),
                                                    dtype=dt, device=dev)
    return MarkerJacTables(
        parents=parents,
        parents_t=t(np.asarray(parents), torch.int32),
        jnts=t(jnts),
        trel=t(trel),
        anc=t(anc),
        ancmask=t(bits.view(np.int64), torch.int64),
        hc=t(hc) if hand_dof else None,
        hands_mean=t(model.hands_mean.cpu().numpy()) if hand_dof else None,
        w3=t(w_i.reshape(M, 3, J)),
        wnz_j=t(wnz_j.reshape(M, 3, -1), torch.int32),
        wnz_w=t(wnz_w.reshape(M, 3, -1)),
        s3=t((w_i @ anc).reshape(M, 3, J)),
        vsh3=t(v_shaped[inst].reshape(M, 3, 3)),
        pdt=t(pdt),
        pd64=t(pdt, torch.float64),
        cf=t(coeffs.detach().cpu().numpy()),
        body_dof=info.body_pose_dof,
        hand_dof=hand_dof,
        hand_blocks=hand_blocks(hc, info.num_hands) if hand_dof else 1,
        djnt=t(djnt),
        dtrel=t(dtrel),
        dv=t(dv),
        dvt=t(dv.transpose(0, 1, 3, 2)),
        jdirs=t(np.stack([dtrel, djnt]).transpose(2, 0, 1, 3).reshape(
            E, 6 * J)),
        vdirs=t(dv.transpose(2, 0, 1, 3).reshape(E, 9 * M)),
    )


def block_diagonal_by_hand(hc: Optional[np.ndarray],
                           num_hands: int) -> Optional[bool]:
    """Whether the hand-PCA components hc (hand_dof, 45 num_hands) map each
    hand's 45 axis-angle columns onto its own hand_dof / num_hands rows
    alone: every entry off those diagonal blocks exactly zero. None without
    hands (no hc)."""
    if hc is None or hc.size == 0:
        return None
    nd, nh = hc.shape
    if num_hands < 1 or nd % num_hands or nh % num_hands:
        return False
    bd, bh = nd // num_hands, nh // num_hands
    off = np.ones(hc.shape, bool)
    for b in range(num_hands):
        off[b * bd:(b + 1) * bd, b * bh:(b + 1) * bh] = False
    return not bool(np.any(hc[off] != 0))


def hand_blocks(hc: Optional[np.ndarray], num_hands: int) -> int:
    """The diagonal blocks of hc the marker_rows kernels take: one a hand
    when hc is block-diagonal by hand (the per-hand products skip exact
    zeros only, so the columns are the full product's bit for bit), else 1,
    the full product."""
    return num_hands if block_diagonal_by_hand(hc, num_hands) else 1


def sparse_weights(w: np.ndarray):
    """The nonzero entries of each row of w (I, J) as lists: (joints (I, K)
    int64, weights (I, K) float32), ascending joints, zero-padded to the
    largest count K (at least 1)."""
    w = np.asarray(w, np.float32)
    nz = w != 0
    K = max(1, int(nz.sum(1).max(initial=0)))
    # stable sort puts each row's nonzero joints first, in ascending order
    order = np.argsort(~nz, axis=1, kind="stable")[:, :K]
    keep = np.take_along_axis(nz, order, 1)
    return (np.where(keep, order, 0),
            np.where(keep, np.take_along_axis(w, order, 1), np.float32(0)))


# ---- fk_smalls ---------------------------------------------------------------

FK_MAX_FRAMES = 4   # frames a block of fk_smalls (csrc/fk_smalls.cu kMaxFrames)


def fk_frames_per_block(F: int, sms: int, with_jac: bool, route: str) -> int:
    """Frames a block of an fk_smalls launch of F frames on a card of `sms`
    SMs, route "", "ext" or "tiled" (measured on the H100: PERF.md §6):
    - with inline extras, FK_MAX_FRAMES at every F: a block copies the
      extra directions once, for all its frames;
    - else with the Jacobian, one: a frame stages 84-93 floats a joint
      (20-23 KB at J=52-55), so shared memory caps an SM at ~10 frames
      whatever the blocking, and blocks of one frame keep the most warps
      resident;
    - else ceil(F / sms), at most FK_MAX_FRAMES: blocks few but still
      spread over the SMs (F = 128 takes 1 frame a block, F = 512 takes 4
      on the H100's 132 SMs)."""
    if route == "ext":
        return FK_MAX_FRAMES
    if with_jac:
        return 1
    return max(1, min(FK_MAX_FRAMES, -(-F // sms)))


def _check_extra(tables: MarkerJacTables, extra, F: int) -> None:
    """Raise unless `extra` matches the tables' E (None when E = 0)."""
    E = tables.n_extra
    if (extra is None) != (E == 0) or (
            extra is not None and tuple(extra.shape) != (F, E)):
        got = None if extra is None else tuple(extra.shape)
        raise ValueError(f"extra: the tables have E={E} extra dims, got {got}")


def _inline_route(tables: MarkerJacTables) -> str:
    """The route of the inline stages: "" or "ext"; raise for tables whose
    extras only the tiled route takes."""
    if tables.n_extra > MAX_INLINE_EXTRAS:
        raise ValueError(f"{tables.n_extra} extra dims: more than "
                         f"{MAX_INLINE_EXTRAS} take the tiled route")
    return "ext" if tables.n_extra else ""


def fk_smalls_plain(theta: torch.Tensor, tables: MarkerJacTables,
                    with_jac: bool,
                    extra: Optional[torch.Tensor] = None) -> JointSmalls:
    """Plain PyTorch version of the `fk_smalls` kernel."""
    _check_extra(tables, extra, theta.shape[0])
    kernels.note_plain(_names(with_jac, _inline_route(tables))[0], theta)
    return joint_smalls(theta, tables.jnts, tables.parents, with_jac,
                        extra, tables.djnt, tables.dtrel)


def fk_smalls(theta: torch.Tensor, tables: MarkerJacTables,
              with_jac: bool,
              extra: Optional[torch.Tensor] = None) -> JointSmalls:
    """Per-frame joint quantities from fullpose axis-angles (F, J, 3) and,
    when the tables have E extra dims, their values extra (F, E)."""
    if not theta.is_cuda:
        return fk_smalls_plain(theta, tables, with_jac, extra)
    F = theta.shape[0]
    J, E = tables.num_joints, tables.n_extra
    kernels.check("theta", theta, (F, J, 3))
    _check_extra(tables, extra, F)
    if E:
        kernels.check("extra", extra, (F, E))
    e = lambda *s: torch.empty(s, dtype=torch.float32, device=theta.device)
    sm = JointSmalls(grot=e(F, J, 3, 3), atr=e(F, J, 3),
                     feat=e(F, J - 1, 3, 3),
                     wrot=e(F, J, 3, 3, 3) if with_jac else None,
                     wtr=e(F, J, 3, 3) if with_jac else None,
                     dr=e(F, J, 3, 3, 3) if with_jac else None,
                     datr=e(F, E, J, 3) if with_jac and E else None)
    p = kernels.ptr
    kernels.launch(
        "fk_smalls_launch", _names(with_jac, _inline_route(tables))[0],
        int(with_jac), fk_frames_per_block(F, kernels.sm_count(theta.device),
                                           with_jac, _inline_route(tables)),
        p(theta), p(tables.ancmask), p(tables.jnts), p(tables.trel), F, J,
        p(sm.grot), p(sm.atr), p(sm.feat), p(sm.wrot), p(sm.wtr), p(sm.dr),
        E, p(extra), p(tables.djnt), p(tables.dtrel), p(sm.datr), frames=F)
    return sm


# ---- marker_rows -------------------------------------------------------------

ROWS_MARKERS = 8        # markers a block (csrc/marker_rows.cu kTM)
ROWS_TILE_FRAMES = 2    # frames a tile (kTF)
ROWS_MAX_TILES = 8      # tiles a block at most
# blocks an SM at the cells' widths: the Jacobian programs, the sim programs
ROWS_BLOCKS_PER_SM = {True: 2, False: 3}


def rows_frames_per_block(F: int, M: int, sms: int, with_jac: bool) -> int:
    """Frames a block of a marker_rows launch of F frames and M markers on a
    card of `sms` SMs: the most tiles a block (at most ROWS_MAX_TILES, so
    that a block stages its markers' tables for many frames) whose grid
    costs within 5 % of the fewest tile-times, counted as whole waves of
    `sms` x ROWS_BLOCKS_PER_SM[with_jac] blocks times tiles a block. On the
    H100's 132 SMs at M = 46, with the Jacobian: 16 frames at F = 4096 and
    2048, 12 at 1024 and 512, 6 at 256, 4 at 128 (192 blocks); a grid of a
    fixed 16 frames would leave 36 SMs idle at F = 128."""
    tiles = -(-F // ROWS_TILE_FRAMES)
    mtiles = -(-M // ROWS_MARKERS)
    slots = max(1, sms * ROWS_BLOCKS_PER_SM[with_jac])
    cost = {n: -(-(-(-tiles // n) * mtiles) // slots) * n
            for n in range(1, ROWS_MAX_TILES + 1)}
    least = min(cost.values())
    n = max(n for n, c in cost.items() if c <= 1.05 * least)
    return n * ROWS_TILE_FRAMES


def _rows_launch_tail(tables: MarkerJacTables, F: int, device,
                     with_jac: bool) -> tuple:
    """The launchers' last arguments: frames a block and hand blocks."""
    return (rows_frames_per_block(F, tables.num_markers,
                                  kernels.sm_count(device), with_jac),
            tables.hand_blocks)


def _check_smalls(sm: JointSmalls, F: int, J: int, with_jac: bool) -> None:
    """Raise unless the joint quantities a marker_rows kernel reads are
    contiguous float32 CUDA tensors of their shapes."""
    kernels.check("grot", sm.grot, (F, J, 3, 3))
    kernels.check("atr", sm.atr, (F, J, 3))
    kernels.check("feat", sm.feat, (F, J - 1, 3, 3))
    if with_jac:
        kernels.check("wrot", sm.wrot, (F, J, 3, 3, 3))
        kernels.check("wtr", sm.wtr, (F, J, 3, 3))
        kernels.check("dr", sm.dr, (F, J, 3, 3, 3))


def _rows_plain(sm: JointSmalls, trans: torch.Tensor,
                tables: MarkerJacTables, with_jac: bool,
                extra: Optional[torch.Tensor] = None,
                vshift: Optional[torch.Tensor] = None):
    """The marker rows' arithmetic: (sim (F, M, 3), the local-frame blocks
    dms (F, M, 3, 3, 3) and jm's column blocks [trans, pose(, extras)]),
    the last two None without the Jacobian. extra (F, E) moves the frame
    vertices along the tables' dv and adds E columns; the tiled route
    passes the summed shift vshift (F, 3M, 3) instead."""
    F = trans.shape[0]
    M, J = tables.num_markers, tables.num_joints
    verts, Jfull, Je = skin_rows(
        sm, tables.w3.reshape(3 * M, J), tables.s3.reshape(3 * M, J),
        tables.vsh3.reshape(3 * M, 3), tables.pd3.reshape(3 * M, 3, -1),
        tables.anc, trans, with_jac, extra,
        tables.dv.reshape(3 * M, -1, 3), vshift)
    # the local frame in float64, as the kernel computes it
    sim, dms = reconstruct_with_grad(verts.reshape(F, M, 3, 3),
                                     tables.cf.to(verts.dtype))
    sim, dms = sim.to(trans.dtype), dms.to(trans.dtype)
    if not with_jac:
        return sim, None, None
    # fold the marker frame into the columns first: 3 rows through the
    # hand-PCA product instead of 9 (the kernel's order)
    U = torch.einsum("fmkca,fmkaq->fmcq", dms,
                     Jfull.reshape(F, M, 3, 3, 3 * J))
    Jpose = hand_chain(U, tables.body_dof, tables.hc)
    eye = torch.eye(3, dtype=sim.dtype, device=sim.device)
    cols = [eye.expand(F, M, 3, 3), Jpose]
    if Je is not None:
        cols.append(torch.einsum("fmkca,fmkae->fmce", dms,
                                 Je.reshape(F, M, 3, 3, -1)))
    return sim, dms, cols


def marker_rows_plain(sm: JointSmalls, trans: torch.Tensor,
                      tables: MarkerJacTables, with_jac: bool,
                      extra: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the `marker_rows` kernel: (sim (F, M, 3),
    jm (F, M, 3, D) or None)."""
    _check_extra(tables, extra, trans.shape[0])
    kernels.note_plain(_names(with_jac, _inline_route(tables))[1], trans)
    sim, _, cols = _rows_plain(sm, trans, tables, with_jac, extra)
    return sim, None if cols is None else torch.cat(cols, dim=-1)


def marker_rows(sm: JointSmalls, trans: torch.Tensor,
                tables: MarkerJacTables, with_jac: bool,
                extra: Optional[torch.Tensor] = None):
    """Simulated markers (F, M, 3) and, with the Jacobian, jm (F, M, 3, D);
    extra (F, E) when the tables have E extra dims."""
    if not trans.is_cuda:
        return marker_rows_plain(sm, trans, tables, with_jac, extra)
    F = trans.shape[0]
    M, J, D, E = (tables.num_markers, tables.num_joints, tables.dof,
                  tables.n_extra)
    kernels.check("trans", trans, (F, 3))
    _check_smalls(sm, F, J, with_jac)
    _check_extra(tables, extra, F)
    if E:
        kernels.check("extra", extra, (F, E))
        if with_jac:
            kernels.check("datr", sm.datr, (F, E, J, 3))
    sim = torch.empty((F, M, 3), dtype=torch.float32, device=trans.device)
    jm = (torch.empty((F, M, 3, D), dtype=torch.float32, device=trans.device)
          if with_jac else None)
    p = kernels.ptr
    kernels.launch(
        "marker_rows_launch", _names(with_jac, _inline_route(tables))[1],
        int(with_jac), F, M, J, tables.feat_n, tables.body_dof,
        tables.hand_dof, D, p(sm.grot), p(sm.atr), p(sm.feat), p(sm.wrot),
        p(sm.wtr), p(sm.dr), p(trans), p(tables.w3), p(tables.s3),
        p(tables.vsh3), p(tables.pdt), p(tables.pd64), p(tables.cf),
        p(tables.ancmask), p(tables.hc), p(sim), p(jm), E, p(extra),
        p(sm.datr), p(tables.dv),
        *_rows_launch_tail(tables, F, trans.device, with_jac), frames=F)
    return sim, jm


def _fold(sim, jm, obs, wrow):
    """The Gauss-Newton data rows (sim - obs) w and jm w, computed exactly as
    the stage-ii system weights the unfolded rows."""
    return (sim - obs) * wrow[..., None], jm * wrow[..., None, None]


def _check_fold_inputs(obs, wrow, F: int, M: int) -> None:
    """Raise unless obs (F, M, 3) and wrow (F, M) are contiguous float32
    CUDA tensors (`marker_resid_and_wjac` makes them so)."""
    kernels.check("obs", obs, (F, M, 3))
    kernels.check("wrow", wrow, (F, M))


def marker_rows_fold_plain(sm: JointSmalls, trans: torch.Tensor,
                           tables: MarkerJacTables, obs: torch.Tensor,
                           wrow: torch.Tensor,
                           extra: Optional[torch.Tensor] = None):
    """Plain PyTorch version of `marker_rows<jac[,ext],fold>`: (rw (F, M, 3),
    jw (F, M, 3, D))."""
    _check_extra(tables, extra, trans.shape[0])
    kernels.note_plain(_names(True, _inline_route(tables), True)[1], trans)
    sim, _, cols = _rows_plain(sm, trans, tables, True, extra)
    return _fold(sim, torch.cat(cols, dim=-1), obs, wrow)


def marker_rows_fold(sm: JointSmalls, trans: torch.Tensor,
                     tables: MarkerJacTables, obs: torch.Tensor,
                     wrow: torch.Tensor,
                     extra: Optional[torch.Tensor] = None):
    """The weighted residual rw = (sim - obs) w (F, M, 3) and the weighted
    Jacobian jw = jm w (F, M, 3, D) from the observed markers obs (F, M, 3)
    and the data weights wrow (F, M), contiguous float32; extra (F, E) when
    the tables have E <= 16 extra dims."""
    if not trans.is_cuda:
        return marker_rows_fold_plain(sm, trans, tables, obs, wrow, extra)
    F = trans.shape[0]
    M, J, D, E = (tables.num_markers, tables.num_joints, tables.dof,
                  tables.n_extra)
    kernels.check("trans", trans, (F, 3))
    _check_fold_inputs(obs, wrow, F, M)
    _check_extra(tables, extra, F)
    if E:
        kernels.check("extra", extra, (F, E))
        kernels.check("datr", sm.datr, (F, E, J, 3))
    _check_smalls(sm, F, J, True)
    rw = torch.empty((F, M, 3), dtype=torch.float32, device=trans.device)
    jw = torch.empty((F, M, 3, D), dtype=torch.float32, device=trans.device)
    p = kernels.ptr
    kernels.launch(
        "marker_rows_fold_launch", _names(True, _inline_route(tables), True)[1],
        F, M, J, tables.feat_n, tables.body_dof, tables.hand_dof, D,
        p(sm.grot), p(sm.atr), p(sm.feat), p(sm.wrot), p(sm.wtr), p(sm.dr),
        p(trans), p(tables.w3), p(tables.s3), p(tables.vsh3), p(tables.pdt),
        p(tables.pd64), p(tables.cf), p(tables.ancmask), p(tables.hc), p(rw),
        p(jw), E,
        p(extra), p(sm.datr), p(tables.dv), p(obs), p(wrow),
        *_rows_launch_tail(tables, F, trans.device, True), frames=F)
    return rw, jw


# ---- the tiled extras route ---------------------------------------------------

def extra_shifts(tables: MarkerJacTables, extra: torch.Tensor):
    """Per-frame shifts of the rest geometry along the E extra directions,
    two matmuls (the JAX package's `_tiled_extra_inputs` leaves them to
    XLA): jshift (F, 2, J, 3) = [sum_e x_e dtrel_e; sum_e x_e djnt_e] and
    vpshift (F, M, 3, 3) = sum_e x_e dv_e [m, k, c]."""
    F = extra.shape[0]
    jshift = torch.matmul(extra, tables.jdirs).reshape(
        F, 2, tables.num_joints, 3)
    vpshift = torch.matmul(extra, tables.vdirs).reshape(
        F, tables.num_markers, 3, 3)
    return jshift.contiguous(), vpshift.contiguous()


def fk_smalls_tiled_plain(theta: torch.Tensor, jshift: torch.Tensor,
                          tables: MarkerJacTables,
                          with_jac: bool) -> JointSmalls:
    """Plain PyTorch version of `fk_smalls<., tiled>`."""
    kernels.note_plain(_names(with_jac, "tiled")[0], theta)
    return joint_smalls(theta, tables.jnts + jshift[:, 1], tables.parents,
                        with_jac, emit_q=with_jac)


def fk_smalls_tiled(theta: torch.Tensor, jshift: torch.Tensor,
                    tables: MarkerJacTables, with_jac: bool) -> JointSmalls:
    """Per-frame joint quantities on the rest geometry shifted by jshift
    (F, 2, J, 3); with the Jacobian also q (F, J, 3, 3), no datr."""
    if not theta.is_cuda:
        return fk_smalls_tiled_plain(theta, jshift, tables, with_jac)
    F, J = theta.shape[0], tables.num_joints
    kernels.check("theta", theta, (F, J, 3))
    kernels.check("jshift", jshift, (F, 2, J, 3))
    e = lambda *s: torch.empty(s, dtype=torch.float32, device=theta.device)
    sm = JointSmalls(grot=e(F, J, 3, 3), atr=e(F, J, 3),
                     feat=e(F, J - 1, 3, 3),
                     wrot=e(F, J, 3, 3, 3) if with_jac else None,
                     wtr=e(F, J, 3, 3) if with_jac else None,
                     dr=e(F, J, 3, 3, 3) if with_jac else None,
                     q=e(F, J, 3, 3) if with_jac else None)
    p = kernels.ptr
    kernels.launch(
        "fk_smalls_tiled_launch", _names(with_jac, "tiled")[0], int(with_jac),
        fk_frames_per_block(F, kernels.sm_count(theta.device), with_jac,
                            "tiled"), p(theta),
        p(tables.ancmask), p(tables.jnts), p(tables.trel), F, J, p(sm.grot),
        p(sm.atr), p(sm.feat), p(sm.wrot), p(sm.wtr), p(sm.dr), p(jshift),
        p(sm.q), frames=F)
    return sm


def extras_tangent_plain(q: torch.Tensor, grot: torch.Tensor,
                         tables: MarkerJacTables) -> torch.Tensor:
    """Plain PyTorch version of `extras_tangent`."""
    kernels.note_plain(TANGENT, q)
    return extras_tangent_rows(q, grot, tables.anc, tables.dtrel, tables.djnt)


def extras_tangent(q: torch.Tensor, grot: torch.Tensor,
                   tables: MarkerJacTables) -> torch.Tensor:
    """datr (F, E, J, 3) = dA_tr/dx_e from the tiled stage's q and grot."""
    if not q.is_cuda:
        return extras_tangent_plain(q, grot, tables)
    F, J, E = q.shape[0], tables.num_joints, tables.n_extra
    kernels.check("q", q, (F, J, 3, 3))
    kernels.check("grot", grot, (F, J, 3, 3))
    datr = torch.empty((F, E, J, 3), dtype=torch.float32, device=q.device)
    p = kernels.ptr
    kernels.launch("extras_tangent_launch", TANGENT, F, J, E, p(q), p(grot),
                   p(tables.dtrel), p(tables.djnt), p(tables.parents_t),
                   p(datr))
    return datr


def _tiled_rows(sm: JointSmalls, trans: torch.Tensor, vpshift: torch.Tensor,
                tables: MarkerJacTables, with_jac: bool):
    """The tiled marker rows' arithmetic: (sim, jm with its last E columns
    zero, uv), the last two None without the Jacobian."""
    F = trans.shape[0]
    M, J = tables.num_markers, tables.num_joints
    sim, dms, cols = _rows_plain(sm, trans, tables, with_jac,
                                 vshift=vpshift.reshape(F, 3 * M, 3))
    if not with_jac:
        return sim, None, None
    jm = torch.cat([*cols, sim.new_zeros((F, M, 3, tables.n_extra))], dim=-1)
    # V = dms T_rot, T_rot rounded to float32 as the skinning rows round it
    T_rot = torch.einsum("ij,fjac->fiac", tables.w3.reshape(3 * M, J).double(),
                         sm.grot.double()).to(trans.dtype)
    V = torch.einsum("fmkcd,fmkdz->fmkcz", dms, T_rot.reshape(F, M, 3, 3, 3))
    uv = torch.cat([dms.reshape(F, M, 27), V.reshape(F, M, 27)], dim=-1)
    return sim, jm, uv


def marker_rows_tiled_plain(sm: JointSmalls, trans: torch.Tensor,
                            vpshift: torch.Tensor, tables: MarkerJacTables,
                            with_jac: bool):
    """Plain PyTorch version of `marker_rows<., tiled>`: (sim (F, M, 3),
    jm (F, M, 3, D) with its last E columns zero, uv (F, M, 54)), the last
    two None without the Jacobian."""
    kernels.note_plain(_names(with_jac, "tiled")[1], trans)
    return _tiled_rows(sm, trans, vpshift, tables, with_jac)


def marker_rows_tiled(sm: JointSmalls, trans: torch.Tensor,
                      vpshift: torch.Tensor, tables: MarkerJacTables,
                      with_jac: bool):
    """Simulated markers (F, M, 3) on frame vertices shifted by vpshift
    (F, M, 3, 3) and, with the Jacobian, jm (F, M, 3, D) with its first
    3 + P columns written and the chain factors uv (F, M, 54)."""
    if not trans.is_cuda:
        return marker_rows_tiled_plain(sm, trans, vpshift, tables, with_jac)
    F = trans.shape[0]
    M, J, D, E = (tables.num_markers, tables.num_joints, tables.dof,
                  tables.n_extra)
    kernels.check("trans", trans, (F, 3))
    kernels.check("vpshift", vpshift, (F, M, 3, 3))
    _check_smalls(sm, F, J, with_jac)
    e = lambda *s: torch.empty(s, dtype=torch.float32, device=trans.device)
    sim = e(F, M, 3)
    jm = e(F, M, 3, D) if with_jac else None
    uv = e(F, M, UV_WIDTH) if with_jac else None
    p = kernels.ptr
    kernels.launch(
        "marker_rows_tiled_launch", _names(with_jac, "tiled")[1],
        int(with_jac), F, M, J, tables.feat_n, tables.body_dof,
        tables.hand_dof, D, E, p(sm.grot), p(sm.atr), p(sm.feat), p(sm.wrot),
        p(sm.wtr), p(sm.dr), p(trans), p(tables.w3), p(tables.s3),
        p(tables.vsh3), p(tables.pdt), p(tables.pd64), p(tables.cf),
        p(tables.ancmask), p(tables.hc), p(vpshift), p(sim), p(jm), p(uv),
        *_rows_launch_tail(tables, F, trans.device, with_jac), frames=F)
    return sim, jm, uv


def marker_rows_tiled_fold_plain(sm: JointSmalls, trans: torch.Tensor,
                                 vpshift: torch.Tensor,
                                 tables: MarkerJacTables, obs: torch.Tensor,
                                 wrow: torch.Tensor):
    """Plain PyTorch version of `marker_rows<jac,tiled,fold>`: (rw (F, M, 3),
    jw (F, M, 3, D) with its last E columns zero, uv w (F, M, 54)), the
    chain factors weighted as the Pallas kernel weights them, so that
    `extras_cols` writes weighted extra columns."""
    kernels.note_plain(ROWS_JAC_TILED_FOLD, trans)
    sim, jm, uv = _tiled_rows(sm, trans, vpshift, tables, True)
    rw, jw = _fold(sim, jm, obs, wrow)
    return rw, jw, uv * wrow[..., None]


def marker_rows_tiled_fold(sm: JointSmalls, trans: torch.Tensor,
                           vpshift: torch.Tensor, tables: MarkerJacTables,
                           obs: torch.Tensor, wrow: torch.Tensor):
    """`marker_rows_tiled` with the Jacobian and the data weights folded in:
    rw (F, M, 3), jw (F, M, 3, D) with its first 3 + P columns written, and
    the weighted chain factors uv w (F, M, 54), from the observed markers
    obs (F, M, 3) and the weights wrow (F, M), contiguous float32."""
    if not trans.is_cuda:
        return marker_rows_tiled_fold_plain(sm, trans, vpshift, tables, obs,
                                            wrow)
    F = trans.shape[0]
    M, J, D, E = (tables.num_markers, tables.num_joints, tables.dof,
                  tables.n_extra)
    kernels.check("trans", trans, (F, 3))
    kernels.check("vpshift", vpshift, (F, M, 3, 3))
    _check_fold_inputs(obs, wrow, F, M)
    _check_smalls(sm, F, J, True)
    e = lambda *s: torch.empty(s, dtype=torch.float32, device=trans.device)
    rw, jw, uv = e(F, M, 3), e(F, M, 3, D), e(F, M, UV_WIDTH)
    p = kernels.ptr
    kernels.launch(
        "marker_rows_tiled_fold_launch", ROWS_JAC_TILED_FOLD, F, M, J,
        tables.feat_n, tables.body_dof, tables.hand_dof, D, E, p(sm.grot),
        p(sm.atr), p(sm.feat), p(sm.wrot), p(sm.wtr), p(sm.dr), p(trans),
        p(tables.w3), p(tables.s3), p(tables.vsh3), p(tables.pdt),
        p(tables.pd64), p(tables.cf), p(tables.ancmask), p(tables.hc),
        p(vpshift), p(rw),
        p(jw), p(uv), p(obs), p(wrow),
        *_rows_launch_tail(tables, F, trans.device, True), frames=F)
    return rw, jw, uv


def extras_cols_plain(datr: torch.Tensor, uv: torch.Tensor,
                      tables: MarkerJacTables, jm: torch.Tensor):
    """Plain PyTorch version of `extras_cols`."""
    kernels.note_plain(COLS, datr)
    jm[..., tables.dof - tables.n_extra:] = extras_cols_rows(
        datr, uv, tables.w3, tables.dv)
    return jm


def extras_cols(datr: torch.Tensor, uv: torch.Tensor,
                tables: MarkerJacTables, jm: torch.Tensor) -> torch.Tensor:
    """Write the E extra columns into jm (F, M, 3, D)[..., D - E:] in place,
    from datr (F, E, J, 3) and the marker rows' uv (F, M, 54); returns jm."""
    if not datr.is_cuda:
        return extras_cols_plain(datr, uv, tables, jm)
    F = datr.shape[0]
    M, J, D, E = (tables.num_markers, tables.num_joints, tables.dof,
                  tables.n_extra)
    kernels.check("datr", datr, (F, E, J, 3))
    kernels.check("uv", uv, (F, M, UV_WIDTH))
    kernels.check("jm", jm, (F, M, 3, D))
    p = kernels.ptr
    kernels.launch("extras_cols_launch", COLS, F, M, J, E, D,
                   tables.wnz_j.shape[-1], p(datr), p(uv), p(tables.wnz_j),
                   p(tables.wnz_w), p(tables.dvt), p(jm))
    return jm


def sim_and_jacobian_tiled(model: SurfaceModel, tables: MarkerJacTables,
                           x: torch.Tensor):
    """The tiled extras route of `marker_sim_and_jacobian` (any E >= 1)."""
    theta, trans, extra = kernel_inputs(model, tables, x)
    jshift, vpshift = extra_shifts(tables, extra)
    sm = fk_smalls_tiled(theta, jshift, tables, True)
    datr = extras_tangent(sm.q, sm.grot, tables)
    sim, jm, uv = marker_rows_tiled(sm, trans, vpshift, tables, True)
    return sim, extras_cols(datr, uv, tables, jm)


def sim_tiled(model: SurfaceModel, tables: MarkerJacTables,
              x: torch.Tensor) -> torch.Tensor:
    """The tiled extras route of `marker_sim` (any E >= 1)."""
    theta, trans, extra = kernel_inputs(model, tables, x)
    jshift, vpshift = extra_shifts(tables, extra)
    return marker_rows_tiled(fk_smalls_tiled(theta, jshift, tables, False),
                             trans, vpshift, tables, False)[0]


# ---- public entry points -----------------------------------------------------

def split_x(x: torch.Tensor, pose_dof: int):
    """(trans, pose, extra) column blocks of packed (N, 3 + P + E) rows: the
    one place that knows the layout of x."""
    return x[:, :3], x[:, 3:3 + pose_dof], x[:, 3 + pose_dof:]


def kernel_inputs(model: SurfaceModel, tables: MarkerJacTables,
                  x: torch.Tensor):
    """The kernels' inputs of packed x: fullpose axis-angles (F, J, 3),
    translations (F, 3) and extras (F, E) or None; the hand-PCA product
    stays a plain matmul, as it stays outside the Pallas kernels."""
    P, E = model.pose_dof, tables.n_extra
    if x.shape[-1] != 3 + P + E:
        raise ValueError(f"x has {x.shape[-1]} columns, expected 3 + {P} "
                         f"+ {E} extra dims of the tables")
    trans, pose, extra = split_x(x.to(torch.float32), P)
    trans = trans.contiguous()
    extra = extra.contiguous() if E else None
    if tables.hc is not None:
        bd = tables.body_dof
        hands = tables.hands_mean + pose[:, bd:] @ tables.hc
        pose = torch.cat([pose[:, :bd], hands], dim=1)
    return pose.reshape(x.shape[0], -1, 3).contiguous(), trans, extra


def marker_sim_and_jacobian(model: SurfaceModel, tables: MarkerJacTables,
                            x: torch.Tensor):
    """x (F, 3+P+E) -> (sim (F, M, 3), jm (F, M, 3, 3+P+E)); more than
    `MAX_INLINE_EXTRAS` extra dims take the tiled route."""
    if tables.route == "tiled":
        return sim_and_jacobian_tiled(model, tables, x)
    theta, trans, extra = kernel_inputs(model, tables, x)
    return marker_rows(fk_smalls(theta, tables, True, extra), trans, tables,
                       True, extra)


def build_marker_jacobian_fn(model: SurfaceModel, idx: MarkerFrameIndices,
                             coeffs: torch.Tensor, betas: torch.Tensor):
    """Freeze a problem's tables and return fn(x (F, 3+P)) -> (sim (F, M,
    3), jm (F, M, 3, 3+P)), `marker_sim_and_jacobian` on them: on a CUDA x
    the `fk_smalls<jac>` and `marker_rows<jac>` kernels, on a CPU x their
    plain versions."""
    tables = prepare_marker_jac_tables(model, idx, coeffs, betas)
    return functools.partial(marker_sim_and_jacobian, model, tables)


def marker_resid_and_wjac(model: SurfaceModel, tables: MarkerJacTables,
                          x: torch.Tensor, obs: torch.Tensor,
                          wrow: torch.Tensor):
    """Weighted-data variant of `marker_sim_and_jacobian`: x (F, 3+P+E),
    obs (F, M, 3), wrow (F, M) -> (rw (F, M, 3), jw (F, M, 3, 3+P+E)) with
    rw = (sim - obs) wrow and jw = jm wrow, the Gauss-Newton data rows
    weighted in the marker kernel (no (F, M, 3, D) weighting pass). The
    route follows the extras' width as in `marker_sim_and_jacobian`; on the
    tiled route the weighted chain factors make the extra columns weighted
    too."""
    obs = obs.to(torch.float32).contiguous()
    wrow = wrow.to(torch.float32).contiguous()
    theta, trans, extra = kernel_inputs(model, tables, x)
    if tables.route == "tiled":
        jshift, vpshift = extra_shifts(tables, extra)
        sm = fk_smalls_tiled(theta, jshift, tables, True)
        datr = extras_tangent(sm.q, sm.grot, tables)
        rw, jw, uv = marker_rows_tiled_fold(sm, trans, vpshift, tables, obs,
                                            wrow)
        return rw, extras_cols(datr, uv, tables, jw)
    return marker_rows_fold(fk_smalls(theta, tables, True, extra), trans,
                            tables, obs, wrow, extra)


def marker_sim(model: SurfaceModel, tables: MarkerJacTables,
               x: torch.Tensor) -> torch.Tensor:
    """x (F, 3+P+E) -> simulated markers (F, M, 3), no derivative chain."""
    if tables.route == "tiled":
        return sim_tiled(model, tables, x)
    theta, trans, extra = kernel_inputs(model, tables, x)
    return marker_rows(fk_smalls(theta, tables, False, extra), trans, tables,
                       False, extra)[0]
