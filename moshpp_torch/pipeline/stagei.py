"""Stage I — the subject's shape (betas), latent marker placements and
per-frame poses, jointly from ~12 sampled frames.

Port of `moshpp_tpu/pipeline/stagei.py` (reference `chmosh.py:83-455`): one
packed parameter vector

  x = [betas | markers_latent | poses (F x P) | trans (F x 3) | exprs?]

so the shared betas couple the frames exactly; data rows through the latent
markers' local frames, the GMM pose prior, per-type init anchors, a betas
regularizer and a signed surface-distance term that keeps each latent
marker at its skin offset; on the last two of the four annealing steps
[1, .5, .25, .125] finger and face regularizers too. Each step freezes the
discrete structure at its start (the markers' frame vertices, the 32
candidate faces of the surface term by exact distance, the vertex unions
and the sign normals) and solves one dogleg whose Jacobian comes from
`torch.func.jacfwd` (`solver/gauss_newton.py::dogleg_solve`); the normal
equations are float32 `bmm`s with TF32 off and the direction a Cholesky
solve. No hand-written kernel lies on this path, as no Pallas kernel lies
on the JAX package's.

`mosh_stagei_solve_batched` solves subjects that share one layout and one
frame count in one batched dogleg: the frozen structures, padded to common
vertex unions, ride the solve's `aux` with a leading subject dim.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from moshpp_torch.markers.vids import smplx_eyeball_mask
from moshpp_torch.models.body_model import (MODEL_TYPE_INFO, SurfaceModel,
                                            lbs_forward, pose_part_ids)
from moshpp_torch.ops.knn import nearest_vertex
from moshpp_torch.ops.marker_transform import (MarkerFrameIndices,
                                               marker_coeffs,
                                               reconstruct_markers,
                                               select_frame_indices)
from moshpp_torch.ops.point_mesh import blend, closest_point_on_triangles
from moshpp_torch.ops.rigid_align import kabsch
from moshpp_torch.ops.rodrigues import rodrigues_inverse
from moshpp_torch.ops.surface import vertex_normals
from moshpp_torch.priors.gmm import MaxMixturePrior, gmm_prior_residual
from moshpp_torch.solver.gauss_newton import (DoglegOptions,
                                              batched_dogleg_solve,
                                              dogleg_solve, fp32_matmul)
from moshpp_torch.utils import spans

NUM_TRAIN_MARKERS = 46.0  # chmosh.py:101

DEFAULT_STAGEI_WEIGHTS = {
    # smplh/smplx table, support_data/conf/moshpp_conf.yaml:105-117
    "poseH": 3.0, "poseF": 3.0, "expr": 34.0, "poseB": 3.0,
    "init_finger_left": 400.0, "init_finger_right": 400.0, "init_finger": 400.0,
    "betas": 10.0, "init": 300.0, "data": 75.0, "surf": 10000.0,
    "annealing": (1.0, 0.5, 0.25, 0.125),
}

# the fields of a subject's context that the batched solve's one residual
# closes over (the frozen structure carries the rest): they must be equal
# across subjects
SHARED_FIELDS = ("lay", "opts", "init_anchor", "init_wt_type", "m2b_j",
                 "prior_ids", "prior", "parts", "face_ids", "base_wt_data")


@dataclasses.dataclass(frozen=True)
class StageIOptions:
    optimize_fingers: bool = False
    optimize_face: bool = False
    optimize_toes: bool = False
    optimize_betas: bool = True
    num_betas: int = 16
    num_expressions: int = 10
    expr_start: int = 300
    maxiter: int = 100
    e_3: float = 1e-3            # opt_settings.stagei_lr
    knn_k: int = 8
    surf_candidates: int = 32    # exact-distance faces per marker
    weights: Optional[Dict] = None

    def wt(self, key: str, default=None):
        w = dict(DEFAULT_STAGEI_WEIGHTS)
        w.update(self.weights or {})
        if default is not None and key not in w:
            return default
        return w[key]


class StageIResult(NamedTuple):
    betas: torch.Tensor                  # (nb,)
    markers_latent: torch.Tensor         # (M, 3)
    latent_labels: List[str]
    markers_latent_vids: Dict[str, int]  # nearest-vid snap per label
    poses: torch.Tensor                  # (F, P)
    trans: torch.Tensor                  # (F, 3)
    exprs: Optional[torch.Tensor]        # (F, ne) when optimize_face
    errs: Dict[str, float]
    markers_sim: torch.Tensor            # (F, M, 3)
    iterations: tuple = ()               # dogleg iterations per annealing step
    host_syncs: int = 0                  # loop-condition reads of the solve


def stagei_result_from_arrays(d, *, device) -> StageIResult:
    """The port's result on `device` from a stage-i result as numpy arrays:
    the fields of the JAX package's `StageIResult` (the NamedTuple or its
    dict), e.g. to chain the JAX stage i into this package's stage ii."""
    d = d._asdict() if hasattr(d, "_asdict") else dict(d)
    t = lambda a: (None if a is None else torch.as_tensor(
        np.asarray(a, np.float32), device=device))
    return StageIResult(
        betas=t(d["betas"]), markers_latent=t(d["markers_latent"]),
        latent_labels=list(d["latent_labels"]),
        markers_latent_vids={k: int(v) for k, v in
                             d["markers_latent_vids"].items()},
        poses=t(d["poses"]), trans=t(d["trans"]), exprs=t(d.get("exprs")),
        errs={k: float(v) for k, v in d["errs"].items()},
        markers_sim=t(d["markers_sim"]))


class _Layout(NamedTuple):
    """Static offsets into the packed parameter vector."""
    nb: int
    M: int
    F: int
    P: int
    ne: int

    @property
    def dim(self):
        return self.nb + 3 * self.M + self.F * (self.P + 3) + self.F * self.ne

    def split(self, x):
        o = 0
        betas = x[o:o + self.nb]; o += self.nb
        latents = x[o:o + 3 * self.M].reshape(self.M, 3); o += 3 * self.M
        poses = x[o:o + self.F * self.P].reshape(self.F, self.P); o += self.F * self.P
        trans = x[o:o + 3 * self.F].reshape(self.F, 3); o += 3 * self.F
        exprs = x[o:].reshape(self.F, self.ne) if self.ne else None
        return betas, latents, poses, trans, exprs

    def pack(self, betas, latents, poses, trans, exprs=None):
        parts = [betas.reshape(-1), latents.reshape(-1), poses.reshape(-1),
                 trans.reshape(-1)]
        if self.ne:
            parts.append(exprs.reshape(-1))
        return torch.cat(parts)


def _full_can_verts(model: SurfaceModel, betas: torch.Tensor) -> torch.Tensor:
    nb = betas.shape[-1]
    return model.v_template + torch.einsum(
        "vcb,b->vc", model.shapedirs[..., :nb], betas)


def _init_latents(model: SurfaceModel, layout_vids: np.ndarray,
                  m2b: np.ndarray) -> torch.Tensor:
    """Initial latent markers: the layout vertex plus the skin offset along
    its vertex normal on the template (chmosh.py:57-80)."""
    vids = torch.as_tensor(np.asarray(layout_vids), dtype=torch.long,
                           device=model.device)
    vn = vertex_normals(model.v_template, model.faces)
    m2b = torch.as_tensor(np.asarray(m2b, np.float32), device=model.device)
    return model.v_template[vids] + vn[vids] * m2b[:, None]


class _StageICtx(NamedTuple):
    """Loop-invariant context of a stage-i solve."""
    model: SurfaceModel
    lay: _Layout
    opts: StageIOptions
    frames_obs: torch.Tensor
    maskf: torch.Tensor
    faces_np: np.ndarray
    exclude_vertex_mask: torch.Tensor
    prior: object                  # MaxMixturePrior, a callable or None
    prior_ids: Optional[torch.Tensor]
    m2b_j: torch.Tensor
    init_anchor: torch.Tensor
    init_wt_type: torch.Tensor
    head_corr_mat: Optional[torch.Tensor]
    head_ids: Optional[torch.Tensor]
    parts: dict
    face_ids: list
    base_wt_data: float


def _check_device(model: SurfaceModel, prior, device) -> torch.device:
    """`device` as a torch.device; ValueError when the model or a GMM prior
    lives elsewhere (nothing is moved)."""
    device = torch.device(device)
    owners = [("model", model.device)]
    if isinstance(prior, MaxMixturePrior):
        owners.append(("prior", prior.means.device))
    for name, dev in owners:
        if dev.type != device.type or (device.index is not None
                                       and dev.index != device.index):
            raise ValueError(f"the {name} lives on {dev}, asked for {device}")
    return device


@fp32_matmul()
def prepare_stagei_context(model: SurfaceModel,
                           frames_obs,
                           frames_mask,
                           layout_vids: np.ndarray,
                           m2b: np.ndarray,
                           type_masks: Dict[str, np.ndarray],
                           opts: StageIOptions = StageIOptions(),
                           prior=None,
                           betas_init: Optional[np.ndarray] = None,
                           exclude_vertex_mask: Optional[np.ndarray] = None,
                           head_corr: Optional[tuple] = None,
                           *, device):
    """The loop-invariant stage-i context and the initial state (betas,
    latents, poses, trans, exprs) on `device`, the poses' roots and trans
    from a per-frame rigid alignment (chmosh.py:228)."""
    device = _check_device(model, prior, device)
    model_type = model.model_type
    parts = pose_part_ids(model_type, optimize_toes=opts.optimize_toes)
    F, M = frames_mask.shape
    P = model.pose_dof
    nb = opts.num_betas
    ne = opts.num_expressions if opts.optimize_face else 0
    lay = _Layout(nb=nb, M=M, F=F, P=P, ne=ne)
    wt = opts.wt
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)

    frames_obs = f32(frames_obs)
    maskf = f32(frames_mask)
    if exclude_vertex_mask is None:
        exclude_vertex_mask = smplx_eyeball_mask(model.v_template.shape[0])
    exclude = torch.as_tensor(np.asarray(exclude_vertex_mask, bool),
                              device=device)

    latents0 = _init_latents(model, layout_vids, m2b)
    # the reference divides the data weight by the latent count, not by the
    # per-frame availability, in stage i (chmosh.py:327)
    base_wt_data = wt("data") * (NUM_TRAIN_MARKERS / M)
    # the prior covers the full body slice, toes included (chmosh.py:354)
    prior_ids = None
    if parts["body"]:
        prior_ids = torch.as_tensor(
            pose_part_ids(model_type, optimize_toes=True)["body"],
            dtype=torch.long, device=device)

    betas = torch.zeros(nb, dtype=torch.float32, device=device)
    if betas_init is not None:
        betas = f32(np.asarray(betas_init)[:nb])
    latents = latents0.clone()
    poses = torch.zeros((F, P), dtype=torch.float32, device=device)
    exprs = torch.zeros((F, ne), dtype=torch.float32, device=device)

    # rigid init per frame against the rest-pose simulated markers
    can_v0 = _full_can_verts(model, betas)
    idx0 = select_frame_indices(can_v0, latents, k=opts.knn_k,
                                exclude_mask=exclude)
    sim_rest = reconstruct_markers(can_v0, idx0,
                                   marker_coeffs(can_v0, latents, idx0))
    j0 = model.joint_template[0] + model.joint_shapedirs[0, :, :nb] @ betas
    rot, t = kabsch(sim_rest.expand(F, -1, -1), frames_obs, maskf)
    trans = t + rot @ j0 - j0
    poses[:, :3] = rodrigues_inverse(rot)

    # per-marker init weight by type (chmosh.py:329-330)
    init_wt_type = np.full(M, wt("init"), np.float32)
    for mtype, mask in type_masks.items():
        init_wt_type[np.asarray(mask, bool)] = wt(f"init_{mtype}", wt("init"))
    head_corr_mat = head_ids = None
    if head_corr is not None:
        head_corr_mat = f32(head_corr[0])
        head_ids = torch.as_tensor(np.asarray(head_corr[1]), dtype=torch.long,
                                   device=device)
        # head markers leave the independent anchor rows (chmosh.py:362-367)
        init_wt_type[np.asarray(head_corr[1])] = 0.0

    ctx = _StageICtx(
        model=model, lay=lay, opts=opts, frames_obs=frames_obs, maskf=maskf,
        faces_np=model.faces.cpu().numpy(), exclude_vertex_mask=exclude,
        prior=prior, prior_ids=prior_ids, m2b_j=f32(m2b),
        init_anchor=latents0, init_wt_type=f32(init_wt_type),
        head_corr_mat=head_corr_mat, head_ids=head_ids, parts=parts,
        face_ids=list(parts["face"]), base_wt_data=base_wt_data)
    return ctx, (betas, latents, poses, trans, exprs)


def _face_sq_distances(verts: torch.Tensor, faces: torch.Tensor,
                       points: torch.Tensor) -> torch.Tensor:
    """Exact squared distance (P, Fc) from every point to every face."""
    ta, tb, tc = (verts[faces[:, i]][None] for i in range(3))
    pj = points[:, None, :]
    cp = blend(closest_point_on_triangles(pj, ta, tb, tc), ta, tb, tc)
    return torch.sum((pj - cp) ** 2, dim=-1)


@spans.spanned(spans.FREEZE)
def _freeze_stagei_structure(ctx: _StageICtx, betas: torch.Tensor,
                             latents: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The discrete structure at (betas, latents), frozen for one annealing
    step: the markers' frame vertex triples (global, and local to the
    canonical and the posed vertex union), the surf_candidates faces nearest
    each latent marker by exact point-triangle distance (global, and their
    corners local to the canonical union), the unions' rows and the sign
    normals at the candidate corners. A dict of tensors, so that subjects
    stack along a leading dim."""
    model, lay, opts = ctx.model, ctx.lay, ctx.opts
    faces = model.faces
    can_v = _full_can_verts(model, betas)
    idx = select_frame_indices(can_v, latents, k=opts.knn_k,
                               exclude_mask=ctx.exclude_vertex_mask)
    stacked = idx.stacked.cpu().numpy()                           # (M, 3)
    vn = vertex_normals(can_v, faces)

    # the nearest surf_candidates faces by np.argsort, as in the JAX package
    d_exact = _face_sq_distances(can_v, faces, latents).cpu().numpy()
    cand_faces = np.argsort(d_exact, axis=1)[:, :opts.surf_candidates]
    cand_vids = ctx.faces_np[cand_faces]                          # (M, K, 3)

    can_union = np.unique(np.concatenate([stacked.ravel(), cand_vids.ravel()]))
    data_union = np.unique(stacked)
    dev = can_v.device
    lng = lambda a: torch.as_tensor(a, dtype=torch.long, device=dev)
    cu, du = lng(can_union), lng(data_union)
    return {
        "frame_vids": lng(stacked),
        "cand_faces": lng(cand_faces),
        "idx_can": lng(np.searchsorted(can_union, stacked)),
        "cand_local": lng(np.searchsorted(can_union, cand_vids)),
        "idx_posed": lng(np.searchsorted(data_union, stacked)),
        "v_template": model.v_template[du],
        "shapedirs": model.shapedirs[du],
        "posedirs": model.posedirs[du],
        "weights": model.weights[du],
        "can_template": model.v_template[cu],
        "can_shapedirs": model.shapedirs[cu][..., :lay.nb],
        "vn_corners": vn[lng(cand_vids)],                         # (M, K, 3, 3)
        "frames_obs": ctx.frames_obs,
        "maskf": ctx.maskf,
    }


# the frozen rows indexed by the canonical and by the data vertex union
_CAN_ROWS = ("can_template", "can_shapedirs")
_DATA_ROWS = ("v_template", "shapedirs", "posedirs", "weights")


def _pad_frozen(fz: dict, u_can: int, u_data: int) -> dict:
    """The vertex unions zero-padded to common sizes, so that subjects'
    structures stack; no local index points at a padded row."""
    def pad(a, n):
        return torch.cat([a, a.new_zeros((n - a.shape[0],) + a.shape[1:])])

    out = dict(fz)
    for k in _CAN_ROWS:
        out[k] = pad(fz[k], u_can)
    for k in _DATA_ROWS:
        out[k] = pad(fz[k], u_data)
    return out


def _stack_frozen(fzs: List[dict]) -> dict:
    u_can = max(fz["can_template"].shape[0] for fz in fzs)
    u_data = max(fz["v_template"].shape[0] for fz in fzs)
    fzs = [_pad_frozen(fz, u_can, u_data) for fz in fzs]
    return {k: torch.stack([fz[k] for fz in fzs]) for k in fzs[0]}


def _frame_betas(ctx: _StageICtx, b: torch.Tensor, ex) -> torch.Tensor:
    """The shape coefficients LBS sees: the betas (nb,) or, with
    expressions, per frame (F, es + ne) the betas and the expressions from
    shapedirs column es = min(expr_start, num_shape_dirs - ne)
    (stagei.py:404-412)."""
    lay, opts = ctx.lay, ctx.opts
    if not lay.ne:
        return b
    es = min(opts.expr_start, ctx.model.num_shape_dirs - lay.ne)
    cols = [b[:min(lay.nb, es)].expand(lay.F, -1)]
    if es > lay.nb:
        cols.append(torch.zeros((lay.F, es - lay.nb), dtype=b.dtype,
                                device=b.device))
    return torch.cat(cols + [ex], dim=1)


def _prior_rows(prior, pose_body: torch.Tensor) -> torch.Tensor:
    """Prior rows (F, R) of the frames' body slices (F, D): a GMM's
    max-mixture rows, or a callable on one frame's slice, over the frames."""
    if isinstance(prior, MaxMixturePrior):
        return gmm_prior_residual(prior, pose_body)
    return torch.func.vmap(prior)(pose_body)


def _stagei_residual_fn(ctx: _StageICtx, anneal: float, detailed: bool):
    """Residual r(x, fz) over the packed vector and a frozen structure for
    one annealing step (chmosh.py:313-406): data rows, the GMM prior, init
    anchors (the head markers' through their correlation), the betas
    regularizer, the signed surface distance and, on detailed steps, the
    finger and face regularizers. The structure arrives as an argument, so
    one residual serves every subject of a batch."""
    model, lay, opts = ctx.model, ctx.lay, ctx.opts
    info = MODEL_TYPE_INFO[model.model_type]
    wt = opts.wt
    M = lay.M
    prior, prior_ids = ctx.prior, ctx.prior_ids
    init_anchor, m2b_j = ctx.init_anchor, ctx.m2b_j
    head_corr_mat, head_ids = ctx.head_corr_mat, ctx.head_ids
    face_ids = ctx.face_ids
    mi = torch.arange(M, device=init_anchor.device)
    fid = torch.as_tensor(face_ids, dtype=torch.long,
                          device=init_anchor.device)

    wt_data = ctx.base_wt_data / anneal
    wt_poseB = wt("poseB") * anneal
    wt_beta = wt("betas") * anneal
    wt_init_step = ctx.init_wt_type * anneal
    wt_surf = wt("surf")
    wt_poseH = wt("poseH") * anneal
    wt_poseF = wt("poseF") * anneal
    wt_expr = wt("expr") * anneal

    def residual(x, fz):
        b, lat, ps, tr, ex = lay.split(x)
        can_sub = fz["can_template"] + torch.einsum(
            "vcb,b->vc", fz["can_shapedirs"], b)
        coeffs = marker_coeffs(can_sub, lat,
                               MarkerFrameIndices(*fz["idx_can"].unbind(1)))
        sub = dataclasses.replace(model, **{k: fz[k] for k in _DATA_ROWS})
        verts = lbs_forward(sub, ps, _frame_betas(ctx, b, ex), tr)  # (F, U, 3)
        sim = reconstruct_markers(
            verts, MarkerFrameIndices(*fz["idx_posed"].unbind(1)), coeffs)
        terms = [((fz["frames_obs"] - sim) * fz["maskf"][..., None]
                  ).reshape(-1) * wt_data]

        if prior is not None and prior_ids is not None:
            terms.append(_prior_rows(prior, ps[:, prior_ids]).reshape(-1)
                         * wt_poseB)

        init_loss = lat - init_anchor
        terms.append((init_loss * wt_init_step[:, None]).reshape(-1))
        if head_corr_mat is not None:
            # the head markers' anchor through their correlation, at the
            # body init weight (chmosh.py:368-369)
            corr_rows = head_corr_mat @ init_loss[head_ids]
            terms.append((corr_rows * (wt("init") * anneal)).reshape(-1))

        if opts.optimize_betas:
            terms.append(b * wt_beta)

        # signed distance to the nearest of the frozen candidate faces; the
        # argmin and the sign normal carry no derivative (stagei.py:445-451)
        cl = fz["cand_local"]
        a, bb, cc = can_sub[cl[..., 0]], can_sub[cl[..., 1]], can_sub[cl[..., 2]]
        pts = lat[:, None, :]
        bary = closest_point_on_triangles(pts, a, bb, cc)           # (M, K, 3)
        cp = blend(bary, a, bb, cc)
        sq = torch.sum((pts - cp) ** 2, dim=-1)                     # (M, K)
        best = torch.argmin(sq, dim=1).detach()
        n_best = torch.sum(fz["vn_corners"][mi, best]
                           * bary[mi, best][..., None], dim=1)
        sign = torch.sign(torch.sum((lat - cp[mi, best]) * n_best.detach(),
                                    dim=-1))
        sign = torch.where(sign == 0, torch.ones_like(sign), sign)
        sdist = sign * torch.sqrt(sq[mi, best] + 1e-12)
        terms.append((sdist - m2b_j) * wt_surf)

        if detailed and opts.optimize_fingers and info.has_hands:
            terms.append((ps[:, info.body_pose_dof:] * wt_poseH).reshape(-1))
        if detailed and opts.optimize_face and face_ids:
            terms.append((ps[:, fid] * wt_poseF).reshape(-1))
            terms.append((ex * wt_expr).reshape(-1))
        return torch.cat(terms)

    return residual


def _stagei_pmask(ctx: _StageICtx, detailed: bool) -> np.ndarray:
    """Free-variable mask for one annealing step (chmosh.py:386-406)."""
    model, lay, opts = ctx.model, ctx.lay, ctx.opts
    info = MODEL_TYPE_INFO[model.model_type]
    F, M, P, nb, ne = lay.F, lay.M, lay.P, lay.nb, lay.ne
    parts, face_ids = ctx.parts, ctx.face_ids

    pmask = np.zeros(lay.dim, np.float32)
    if opts.optimize_betas:
        pmask[:nb] = 1.0
    pmask[nb:nb + 3 * M] = 1.0
    pose_on = list(parts["root"]) + list(parts["body"])
    if detailed and opts.optimize_fingers and info.has_hands:
        pose_on += list(range(info.body_pose_dof, P))
    if detailed and opts.optimize_face:
        pose_on += list(face_ids)
    o = nb + 3 * M
    on = np.asarray(sorted(set(pose_on)), np.int64)
    pmask[o + (np.arange(F)[:, None] * P + on[None]).ravel()] = 1.0
    pmask[o + F * P: o + F * P + 3 * F] = 1.0   # trans
    if ne and detailed and opts.optimize_face:
        pmask[o + F * P + 3 * F:] = 1.0
    return pmask


def build_stagei_step(ctx: _StageICtx, betas, latents, anneal: float,
                      detailed: bool):
    """Freeze the structure at (betas, latents) and assemble one annealing
    step: (residual over the packed vector, pmask)."""
    fz = _freeze_stagei_structure(ctx, betas, latents)
    rf = _stagei_residual_fn(ctx, anneal, detailed)
    return (lambda x: rf(x, fz)), _stagei_pmask(ctx, detailed)


def _dogleg_options(opts: StageIOptions) -> DoglegOptions:
    return DoglegOptions(maxiter=opts.maxiter, e_3=opts.e_3, delta_0=0.5)


def _steps(opts: StageIOptions):
    """(anneal, detailed) of each annealing step: the last two are
    detailed (chmosh.py:314)."""
    annealing = tuple(opts.wt("annealing"))
    return [(a, i > len(annealing) - 3) for i, a in enumerate(annealing)]


def mosh_stagei_solve(model: SurfaceModel,
                      frames_obs,
                      frames_mask,
                      latent_labels: List[str],
                      layout_vids: np.ndarray,
                      m2b: np.ndarray,
                      type_masks: Dict[str, np.ndarray],
                      opts: StageIOptions = StageIOptions(),
                      prior=None,
                      betas_init: Optional[np.ndarray] = None,
                      exclude_vertex_mask: Optional[np.ndarray] = None,
                      head_corr: Optional[tuple] = None,
                      *, device) -> StageIResult:
    """The full annealed stage-i solve of one subject on `device`.

    frames_obs (F, M, 3) observed markers in meters aligned to
    `latent_labels`, frames_mask (F, M) availability (numpy or tensors);
    layout_vids, m2b, type_masks from `markers.layout.layout_arrays`;
    `betas_init` starts the betas (still optimized unless
    opts.optimize_betas is off); `head_corr` (corr (H, H), head marker
    indices (H,)) couples the head markers' init anchors through the
    correlation (chmosh.py:252-266). The model and a GMM prior must live on
    `device` (ValueError otherwise)."""
    ctx, state = prepare_stagei_context(
        model, frames_obs, frames_mask, layout_vids, m2b, type_masks,
        opts=opts, prior=prior, betas_init=betas_init,
        exclude_vertex_mask=exclude_vertex_mask, head_corr=head_corr,
        device=device)
    betas, latents, poses, trans, exprs = state
    lay = ctx.lay
    iters, syncs = [], 0
    with fp32_matmul():
        for anneal, detailed in _steps(opts):
            residual, pmask = build_stagei_step(ctx, betas, latents, anneal,
                                                detailed)
            x0 = lay.pack(betas, latents, poses, trans, exprs)
            res = dogleg_solve(residual, x0, _dogleg_options(opts),
                               param_mask=torch.as_tensor(pmask,
                                                          device=x0.device))
            betas, latents, poses, trans, ex = lay.split(res.x)
            if lay.ne:
                exprs = ex
            iters.append(int(res.iterations))
            syncs += res.host_syncs
        out = _stagei_outputs(ctx, latent_labels, betas, latents, poses,
                              trans, exprs)
    return out._replace(iterations=tuple(iters), host_syncs=syncs)


def _check_shared(ctxs: Sequence[_StageICtx]) -> None:
    """ValueError naming the first field of SHARED_FIELDS in which a
    subject's context differs from the first subject's: the batched solve
    builds its one residual and pmask from the first."""
    def same(a, b):
        if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
            return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                    and a.shape == b.shape and torch.equal(a, b))
        if isinstance(a, MaxMixturePrior) and isinstance(b, MaxMixturePrior):
            return all(same(getattr(a, f.name), getattr(b, f.name))
                       for f in dataclasses.fields(a))
        if isinstance(a, MaxMixturePrior) or isinstance(b, MaxMixturePrior):
            return False
        if callable(a) or callable(b):
            return a is b
        return a == b

    for s, ctx in enumerate(ctxs[1:], 1):
        for name in SHARED_FIELDS:
            if not same(getattr(ctxs[0], name), getattr(ctx, name)):
                raise ValueError(
                    f"subject {s} differs from subject 0 in {name}: the "
                    f"batched stage-i solve shares one residual")


def mosh_stagei_solve_batched(model: SurfaceModel,
                              frames_obs: Union[np.ndarray, torch.Tensor,
                                                Sequence],
                              frames_mask: Union[np.ndarray, torch.Tensor,
                                                 Sequence],
                              latent_labels: List[str],
                              layout_vids: np.ndarray,
                              m2b: np.ndarray,
                              type_masks: Dict[str, np.ndarray],
                              opts: StageIOptions = StageIOptions(),
                              prior=None,
                              betas_init: Optional[np.ndarray] = None,
                              exclude_vertex_mask: Optional[np.ndarray] = None,
                              *, device) -> List[StageIResult]:
    """Stage i of S subjects in one batched dogleg a step on `device`.

    frames_obs (S, F, M, 3) and frames_mask (S, F, M), or a sequence of
    per-subject arrays. All subjects must share one layout and one frame
    count (ValueError otherwise), as in the JAX package; every field the
    shared residual closes over is checked equal across subjects. Each
    step freezes every subject's structure, pads the vertex unions to
    common sizes and stacks them into the solve's aux. Head markers are in
    the single solve only, as in the JAX package. Returns one result per
    subject."""
    S = len(frames_obs)
    shapes = {(tuple(o.shape), tuple(m.shape))
              for o, m in zip(frames_obs, frames_mask)}
    if len(frames_mask) != S or len(shapes) != 1 or next(iter(shapes)) != (
            (len(frames_obs[0]), len(layout_vids), 3),
            (len(frames_obs[0]), len(layout_vids))):
        raise ValueError("All subjects must share one layout and one frame "
                         "count.")
    pairs = [prepare_stagei_context(
        model, frames_obs[s], frames_mask[s], layout_vids, m2b, type_masks,
        opts=opts, prior=prior, betas_init=betas_init,
        exclude_vertex_mask=exclude_vertex_mask, device=device)
        for s in range(S)]
    ctxs = [p[0] for p in pairs]
    _check_shared(ctxs)
    lay = ctxs[0].lay
    states = [list(p[1]) for p in pairs]
    iters, syncs = [[] for _ in range(S)], 0
    with fp32_matmul():
        for anneal, detailed in _steps(opts):
            frozen = _stack_frozen([_freeze_stagei_structure(c, st[0], st[1])
                                    for c, st in zip(ctxs, states)])
            rf = _stagei_residual_fn(ctxs[0], anneal, detailed)
            x0 = torch.stack([lay.pack(*st) for st in states])
            res = batched_dogleg_solve(
                rf, x0, frozen, _dogleg_options(opts),
                param_mask=torch.as_tensor(_stagei_pmask(ctxs[0], detailed),
                                           device=x0.device))
            syncs += res.host_syncs
            for s in range(S):
                b, lat, ps, tr, ex = lay.split(res.x[s])
                states[s][:4] = [b, lat, ps, tr]
                if lay.ne:
                    states[s][4] = ex
                iters[s].append(int(res.iterations[s]))
        return [_stagei_outputs(ctxs[s], latent_labels, *states[s])._replace(
                    iterations=tuple(iters[s]), host_syncs=syncs)
                for s in range(S)]


def _stagei_outputs(ctx: _StageICtx, latent_labels, betas, latents, poses,
                    trans, exprs) -> StageIResult:
    """The nearest-vertex snap of the latent markers (chmosh.py:422-431),
    the markers simulated on the full mesh and the mean data error."""
    model, opts = ctx.model, ctx.opts
    can_v = _full_can_verts(model, betas)
    snap = nearest_vertex(latents, can_v).cpu().numpy()
    idx = select_frame_indices(can_v, latents, k=opts.knn_k,
                               exclude_mask=ctx.exclude_vertex_mask)
    coeffs = marker_coeffs(can_v, latents, idx)
    sims = reconstruct_markers(
        lbs_forward(model, poses, _frame_betas(ctx, betas, exprs), trans),
        idx, coeffs)
    err = torch.linalg.vector_norm(sims - ctx.frames_obs, dim=-1) * ctx.maskf
    data_mean = float(err.sum()) / max(float(ctx.maskf.sum()), 1.0)
    return StageIResult(
        betas=betas, markers_latent=latents,
        latent_labels=list(latent_labels),
        markers_latent_vids={l: int(v) for l, v in zip(latent_labels, snap)},
        poses=poses, trans=trans, exprs=exprs if ctx.lay.ne else None,
        errs={"data_mean_m": data_mean}, markers_sim=sims)
