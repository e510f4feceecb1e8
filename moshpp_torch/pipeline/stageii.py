"""Stage II — per-frame pose (+trans) estimation, batched over frames.

Port of `moshpp_tpu/pipeline/stageii.py` for the main path: the unchunked
`mosh_stageii_solve` schedule with a GMM (or no) body prior and no extra
shape dims. The frame axis is data-parallel exactly as in the JAX package:

  pass A: every S-th frame (anchor) gets the reference's first-frame
    treatment (rigid init, annealed prior solves [10w, 5w, w], a full-pose
    solve); the frames in between start from per-joint quaternion slerps
    between anchors; then all frames get step 1 (trans + body) and step 2
    (full pose);
  pass B: Jacobi smoothing sweeps re-create the sequential velocity term
    pose_t ~ 2 pose_{t-1} - pose_{t-2}; a tight polish solve ends it.

Each phase is one batched dogleg solve (`solver/gauss_newton.py`). Its
Gauss-Newton system is assembled directly: the marker rows and their exact
Jacobian from the marker kernels (`ops/marker_jac.py`), the normal
equations B = JdᵀJd as one float32 `torch.bmm` with TF32 off, the prior and
regularizers as analytic blocks. The direction is the fused dogleg kernel
(`solver/pcg.py`) in PCG phases and a batched Cholesky otherwise; on CUDA
the polish runs deep PCG through the kernel.

Not ported yet (raise NotImplementedError): chunked solves of long
sequences, `return_report`, `on_phase`, `mesh`, extra shape dims (DMPL,
expressions), callable priors and non-contiguous prior slices.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from moshpp_torch.models.body_model import (MODEL_TYPE_INFO, SurfaceModel,
                                            fullpose_from_pose, lbs_forward,
                                            pose_part_ids)
from moshpp_torch.ops.marker_jac import (MarkerJacTables, marker_sim,
                                         marker_sim_and_jacobian,
                                         prepare_marker_jac_tables)
from moshpp_torch.ops.marker_transform import (MarkerFrameIndices,
                                               marker_coeffs,
                                               reconstruct_markers,
                                               select_frame_indices)
from moshpp_torch.ops.rigid_align import kabsch
from moshpp_torch.ops.rodrigues import rodrigues_inverse, slerp_axis_angle
from moshpp_torch.priors.gmm import MaxMixturePrior, select_component
from moshpp_torch.solver.gauss_newton import (DoglegOptions, GNSystem,
                                              batched_system_solve)

NUM_TRAIN_MARKERS = 46.0  # weight-normalization constant (chmosh.py:460)

DEFAULT_STAGEII_WEIGHTS = {
    # smplh/smplx table, support_data/conf/moshpp_conf.yaml:118-125
    "data": 400.0, "velo": 2.5, "poseB": 1.6, "poseH": 1.0, "annealing": 2.5,
    # extra velocity weight on the hand-PCA dofs (1.0 = off)
    "velo_hands": 1.0,
}


@dataclasses.dataclass(frozen=True)
class StageIIOptions:
    optimize_fingers: bool = False
    optimize_face: bool = False       # not ported: raises
    optimize_toes: bool = False
    optimize_dynamics: bool = False   # not ported: raises
    num_betas: int = 16
    maxiter: int = 100
    smoothing_sweeps: int = 2
    e_3_polish: float = 1e-4
    e_3_anneal: float = 3e-3
    linear_solver: str = "pcg"        # 'pcg' | 'cholesky'
    cg_iters: int = 24
    # polish direction: 'auto' = deep PCG through the CUDA kernel on CUDA,
    # Cholesky elsewhere; 'cholesky' | 'pcg' force
    polish_solver: str = "auto"
    cg_iters_polish: int = 128
    anchor_stride: int = 8
    compact_buckets: Tuple[int, ...] = (2, 8, 32)
    # sequences longer than this solve in chunks in the JAX package; the
    # port runs one batch and raises beyond it
    chunk_frames: int = 16384
    weights: Optional[Dict[str, float]] = None
    knn_k: int = 8

    def wt(self, key: str) -> float:
        return (self.weights or DEFAULT_STAGEII_WEIGHTS).get(
            key, DEFAULT_STAGEII_WEIGHTS[key])


@dataclasses.dataclass(frozen=True)
class StageIIProblem:
    """Frozen per-subject context: vertex-subsetted model + marker transport."""
    sub_model: SurfaceModel
    frame_c0: torch.Tensor     # (M,) local (subsetted) vertex indices
    frame_c1: torch.Tensor
    frame_c2: torch.Tensor
    coeffs: torch.Tensor       # (M, 3) frozen latent-marker coefficients
    betas: torch.Tensor        # (B,) frozen subject shape
    tables: MarkerJacTables    # marker-kernel tables

    @property
    def indices(self) -> MarkerFrameIndices:
        return MarkerFrameIndices(self.frame_c0, self.frame_c1, self.frame_c2)

    @property
    def num_markers(self) -> int:
        return self.coeffs.shape[0]

    @property
    def device(self) -> torch.device:
        return self.coeffs.device


class StageIIResult(NamedTuple):
    trans: torch.Tensor         # (F, 3)
    pose: torch.Tensor          # (F, P) optimization pose vector
    fullpose: torch.Tensor      # (F, 3*J) expanded axis-angles
    extra: torch.Tensor         # (F, 0): no extra dims in this port
    markers_sim: torch.Tensor   # (F, M, 3)
    data_err: torch.Tensor      # (F,) mean distance over observed markers (m)
    iterations: torch.Tensor    # (F,) iterations of the final (polish) solve
    host_syncs: int             # loop-condition reads over all phases


def _check_supported(opts: StageIIOptions) -> None:
    if opts.optimize_face or opts.optimize_dynamics:
        raise NotImplementedError(
            "extra shape dims (expressions, DMPL) are not ported yet")


def _problem(sub_model, local, coeffs, betas, opts) -> StageIIProblem:
    dev = sub_model.device
    local = torch.as_tensor(np.asarray(local), dtype=torch.long, device=dev)
    indices = MarkerFrameIndices(local[:, 0], local[:, 1], local[:, 2])
    coeffs = torch.as_tensor(coeffs, dtype=torch.float32, device=dev)
    betas = torch.as_tensor(betas, dtype=torch.float32, device=dev)
    tables = prepare_marker_jac_tables(sub_model, indices, coeffs,
                                       betas[:opts.num_betas])
    return StageIIProblem(sub_model, indices.c0, indices.c1, indices.c2,
                          coeffs, betas, tables)


def prepare_stageii_problem(model: SurfaceModel,
                            betas: np.ndarray,
                            markers_latent: np.ndarray,
                            opts: StageIIOptions = StageIIOptions(),
                            exclude_vertex_mask: Optional[np.ndarray] = None,
                            *, device) -> StageIIProblem:
    """Freeze the stage-i outputs into a solver context on `device`.

    The latent markers' local frames come from the canonical shaped body;
    the model is then gathered to the union of frame vertices. The SMPL-X
    eyeball mask of the JAX package is not applied by default: pass
    `exclude_vertex_mask` (V,) bool to drop vertices from the frames.
    """
    _check_supported(opts)
    model = model.to(device)
    betas = torch.as_tensor(np.asarray(betas, np.float32), device=device)
    lat = torch.as_tensor(np.asarray(markers_latent, np.float32), device=device)
    nb = betas.shape[-1]
    can_verts = model.v_template + torch.einsum(
        "vcb,b->vc", model.shapedirs[..., :nb], betas)
    excl = (None if exclude_vertex_mask is None else
            torch.as_tensor(np.asarray(exclude_vertex_mask, bool), device=device))
    idx = select_frame_indices(can_verts, lat, k=opts.knn_k, exclude_mask=excl)
    coeffs = marker_coeffs(can_verts, lat, idx)
    stacked = idx.stacked.cpu().numpy()
    union, local = np.unique(stacked, return_inverse=True)
    return _problem(model.subset(union), local.reshape(stacked.shape),
                    coeffs, betas, opts)


def problem_from_arrays(sub_model: SurfaceModel, frame_idx: np.ndarray,
                        coeffs: np.ndarray, betas: np.ndarray,
                        opts: StageIIOptions = StageIIOptions(),
                        *, device) -> StageIIProblem:
    """A problem from frozen arrays, e.g. the numpy fields of a JAX
    `StageIIProblem`: the subset model, local frame indices (M, 3), marker
    coefficients (M, 3) and betas."""
    _check_supported(opts)
    return _problem(sub_model.to(device), np.array(frame_idx),
                    np.array(coeffs, np.float32),
                    np.array(betas, np.float32), opts)


def simulate_markers(prob: StageIIProblem, opts: StageIIOptions,
                     x: torch.Tensor) -> torch.Tensor:
    """Markers (N, M, 3) from packed (N, 3 + P) parameters, through the plain
    forward model (not the kernels), as the JAX package's outputs are."""
    model = prob.sub_model
    P = model.pose_dof
    verts = lbs_forward(model, x[:, 3:3 + P], prob.betas[:opts.num_betas],
                        x[:, :3])
    return reconstruct_markers(verts, prob.indices, prob.coeffs)


class _TermSpec(NamedTuple):
    body_rng: Optional[Tuple[int, int]]   # x-range of the prior's pose slice
    finger_rng: Optional[Tuple[int, int]]  # x-range of the hand-PCA tail


def _term_spec(prob: StageIIProblem, opts: StageIIOptions,
               model_type: str) -> _TermSpec:
    info = MODEL_TYPE_INFO[model_type]
    P = prob.sub_model.pose_dof
    prior_pose = [i for i in pose_part_ids(model_type, optimize_toes=True)["body"]
                  if i >= 3]
    body_rng = None
    if prior_pose:
        ids = np.asarray(prior_pose)
        if not np.all(np.diff(ids) == 1):
            raise NotImplementedError(
                f"{model_type}: non-contiguous prior slice is not ported yet")
        body_rng = (3 + int(ids[0]), 3 + int(ids[-1]) + 1)
    finger_rng = ((3 + info.body_pose_dof, 3 + P)
                  if (opts.optimize_fingers and info.has_hands) else None)
    return _TermSpec(body_rng, finger_rng)


def _velo_weight_vec(prob, opts, spec, device) -> torch.Tensor:
    """Per-dof velocity weights over the pose vector (hand-PCA dofs scaled
    by `velo_hands`)."""
    P = prob.sub_model.pose_dof
    w = np.full(P, float(opts.wt("velo")), np.float32)
    vh = float(opts.wt("velo_hands"))
    if vh != 1.0 and spec.finger_rng is not None:
        w[spec.finger_rng[0] - 3:spec.finger_rng[1] - 3] *= vh
    return torch.as_tensor(w, device=device)


def make_stageii_system(prob: StageIIProblem,
                        opts: StageIIOptions,
                        prior: Optional[MaxMixturePrior],
                        model_type: str) -> GNSystem:
    """Batched Gauss-Newton system (x (N, D), aux) -> (f, g, B (N, D, D)).

    aux values carry a leading N: markers (N, M, 3), mask (N, M), wt_data,
    anneal, wt_pose_scale (N,), velo_anchor (N, P), velo_on (N,).
    """
    _check_supported(opts)
    if prior is not None and not isinstance(prior, MaxMixturePrior):
        raise NotImplementedError("callable priors are not ported yet")
    spec = _term_spec(prob, opts, model_type)
    model = prob.sub_model
    tables = prob.tables
    P = model.pose_dof
    D = 3 + P
    wt = opts.wt
    velo_w = _velo_weight_vec(prob, opts, spec, prob.device)
    use_prior = prior is not None and spec.body_rng is not None
    if use_prior:
        # per-component precision quadratic 0.5 L Lᵀ, built once
        PP = 0.5 * torch.einsum("kde,kfe->kdf", prior.chols, prior.chols)

    def quad(x, aux, f, cost_only: bool):
        """Prior and regularizer terms: f, and unless `cost_only` their
        gradient (N, D), diagonal (N, D) and body-prior block."""
        g = dvec = ppw = None
        if not cost_only:
            g = torch.zeros_like(x)
            dvec = torch.zeros_like(x)
        if use_prior:
            w = wt("poseB") * aux["anneal"] * aux["wt_pose_scale"]
            w2 = w * w
            s, e = spec.body_rng
            xb = x[:, s:e]
            k = select_component(prior, xb)
            q = xb - prior.means[k]
            PPk = PP[k]
            gq = torch.bmm(PPk, q[..., None])[..., 0]
            f = f + w2 * (torch.sum(q * gq, -1) + prior.sqrt_neg_log_w[k] ** 2)
            if not cost_only:
                g[:, s:e] += w2[:, None] * gq
                ppw = w2[:, None, None] * PPk

        def diag(f, s, e, vals, w):
            w2 = w * w
            f = f + torch.sum(w2 * vals * vals, -1)
            if not cost_only:
                g[:, s:e] += w2 * vals
                dvec[:, s:e] += w2
            return f

        if spec.finger_rng is not None:
            s, e = spec.finger_rng
            wf = (wt("poseH") * aux["anneal"])[:, None]
            f = diag(f, s, e, x[:, s:e], wf)
        pose = x[:, 3:3 + P]
        f = diag(f, 3, 3 + P, pose - aux["velo_anchor"],
                 velo_w[None, :] * aux["velo_on"][:, None])
        return f, g, dvec, ppw

    def data_rows(sim, aux):
        wrow = aux["mask"] * aux["wt_data"][:, None]               # (N, M)
        return (sim - aux["markers"]) * wrow[..., None], wrow

    def system_fn(x, aux):
        N = x.shape[0]
        sim, Jm = marker_sim_and_jacobian(model, tables, x)
        rd, wrow = data_rows(sim, aux)
        Jd = Jm * wrow[..., None, None]
        f0 = torch.sum(rd * rd, dim=(1, 2))
        g0 = torch.sum(Jd * rd[..., None], dim=(1, 2))
        J2 = Jd.reshape(N, -1, D)
        P0 = 0.5 * torch.bmm(J2.transpose(1, 2), J2)
        f, gq, dvec, ppw = quad(x, aux, f0, cost_only=False)
        # symmetrize as the JAX assembly does (B = P0 + P0ᵀ): the direction
        # kernel reads only B's leading index
        B = P0 + P0.transpose(1, 2) + torch.diag_embed(dvec)
        if ppw is not None:
            s, e = spec.body_rng
            B[:, s:e, s:e] += ppw
        return f, g0 + gq, B

    def cost_fn(x, aux):
        rd, _ = data_rows(marker_sim(model, tables, x), aux)
        return quad(x, aux, torch.sum(rd * rd, dim=(1, 2)), cost_only=True)[0]

    return GNSystem(system_fn, cost_fn)


def _param_masks(model: SurfaceModel, opts: StageIIOptions, model_type: str,
                 device):
    """(step1, step2) binary masks over the packed x vector."""
    info = MODEL_TYPE_INFO[model_type]
    parts = pose_part_ids(model_type, optimize_toes=opts.optimize_toes)
    P = model.pose_dof
    step1 = np.zeros(3 + P, np.float32)
    step1[:3] = 1.0
    for i in parts["root"] + parts["body"]:
        step1[3 + i] = 1.0
    if model_type == "mano":
        step1[3 + info.body_pose_dof: 3 + P] = 1.0
    step2 = step1.copy()
    if opts.optimize_fingers and info.has_hands:
        step2[3 + info.body_pose_dof: 3 + P] = 1.0
    t = lambda a: torch.as_tensor(a, device=device)
    return t(step1), t(step2)


def rigid_init(prob: StageIIProblem, opts: StageIIOptions,
               markers_obs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-frame rigid initialization about the root joint: packed x0 (F, D)."""
    model = prob.sub_model
    P = model.pose_dof
    F = markers_obs.shape[0]
    dev = markers_obs.device
    sim_rest = simulate_markers(
        prob, opts, torch.zeros((1, 3 + P), device=dev))[0]     # (M, 3)
    nb = opts.num_betas
    betas = prob.betas[:nb]
    j0 = model.joint_template[0] + model.joint_shapedirs[0, :, :betas.shape[0]] @ betas
    rot, t = kabsch(sim_rest.expand(F, -1, -1), markers_obs, mask)
    rv = rodrigues_inverse(rot)
    trans = t + rot @ j0 - j0
    x = torch.zeros((F, 3 + P), dtype=torch.float32, device=dev)
    x[:, :3] = trans
    x[:, 3:6] = rv
    return x


def _interp_x(xa: torch.Tensor, seg_lo: torch.Tensor, seg_hi: torch.Tensor,
              alpha: torch.Tensor, model: SurfaceModel) -> torch.Tensor:
    """Rotation-aware interpolation between anchor solves: joint axis-angles
    by per-joint quaternion slerp, the rest linearly."""
    lo = xa[seg_lo]
    hi = xa[seg_hi]
    a = alpha[:, None]
    lin = (1.0 - a) * lo + a * hi
    bd = model.info.body_pose_dof
    n_j = bd // 3
    aa = slerp_axis_angle(lo[:, 3:3 + bd].reshape(-1, n_j, 3),
                          hi[:, 3:3 + bd].reshape(-1, n_j, 3),
                          alpha[:, None, None])
    lin[:, 3:3 + bd] = aa.reshape(-1, bd)
    return lin


def _velo_aux(x: torch.Tensor, P: int):
    """Velocity extrapolation anchors 2 pose_{t-1} - pose_{t-2} and their
    on-flags (frames >= 2)."""
    F = x.shape[0]
    pose = x[:, 3:3 + P]
    anchor = 2.0 * torch.roll(pose, 1, 0) - torch.roll(pose, 2, 0)
    on = (torch.arange(F, device=x.device) >= 2).to(torch.float32)
    return anchor * on[:, None], on


@contextlib.contextmanager
def _fp32_matmul():
    """Full-float32 products for the solve: TF32 off for cuBLAS and cuDNN,
    restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def mosh_stageii_solve(prob: StageIIProblem,
                       opts: StageIIOptions,
                       markers_obs,
                       mask,
                       prior: Optional[MaxMixturePrior] = None,
                       model_type: Optional[str] = None,
                       return_report: bool = False,
                       on_phase=None,
                       mesh=None,
                       *, device) -> StageIIResult:
    """Solve all frames on `device` (the problem's device).

    markers_obs (F, M, 3) in meters and mask (F, M) bool, numpy or tensors.
    """
    if return_report or on_phase is not None or mesh is not None:
        raise NotImplementedError(
            "return_report, on_phase and mesh are not ported yet")
    device = torch.device(device)
    if prob.device.type != device.type:
        raise ValueError(f"problem lives on {prob.device}, asked for {device}")
    F = markers_obs.shape[0]
    if opts.chunk_frames and F > opts.chunk_frames:
        raise NotImplementedError(
            f"{F} frames > chunk_frames={opts.chunk_frames}: chunked solves "
            "are not ported yet")
    with _fp32_matmul():
        return _solve(prob, opts, markers_obs, mask, prior,
                      model_type or prob.sub_model.model_type, device)


def _solve(prob, opts, markers_obs, mask, prior, model_type, device):
    model = prob.sub_model
    obs = torch.as_tensor(markers_obs, dtype=torch.float32, device=device)
    maskf = torch.as_tensor(mask, device=device).to(torch.float32)
    F, M = maskf.shape
    P = model.pose_dof
    wt = opts.wt
    system = make_stageii_system(prob, opts, prior, model_type)

    dl_opts = DoglegOptions(maxiter=opts.maxiter, delta_0=0.5,
                            linear_solver=opts.linear_solver,
                            cg_iters=opts.cg_iters)
    polish_solver = opts.polish_solver
    if polish_solver == "auto":
        polish_solver = "pcg" if device.type == "cuda" else "cholesky"
    dl_polish = dataclasses.replace(dl_opts, linear_solver=polish_solver,
                                    cg_iters=opts.cg_iters_polish)

    n_obs = torch.sum(maskf, dim=1)
    wt_data = wt("data") * NUM_TRAIN_MARKERS / torch.clamp(n_obs, min=1.0)
    anneal = 1.0 + (M - n_obs) / M * wt("annealing")

    def aux_for(idx, scale=1.0):
        n = F if idx is None else len(idx)
        pick = (lambda a: a) if idx is None else (lambda a: a[idx])
        z = torch.zeros((n,), dtype=torch.float32, device=device)
        return {"markers": pick(obs), "mask": pick(maskf),
                "wt_data": pick(wt_data), "anneal": pick(anneal),
                "wt_pose_scale": torch.full((n,), scale, device=device),
                "velo_anchor": torch.zeros((n, P), device=device),
                "velo_on": z}

    syncs = 0

    def run(x, aux, pmask, e3, dl, use_velo=False):
        nonlocal syncs
        if use_velo:
            va, von = _velo_aux(x, P)
            aux = dict(aux, velo_anchor=va, velo_on=von)
        r = batched_system_solve(system, x, aux, dl, param_mask=pmask,
                                 e_3=e3, compact_buckets=opts.compact_buckets)
        syncs += r.host_syncs
        return r.x, r.iterations

    step1_mask, step2_mask = _param_masks(model, opts, model_type, device)
    aux_full = aux_for(None)

    # ---- pass A: anchor solves + slerped warm starts ------------------------
    S = max(int(opts.anchor_stride), 1)
    if S > 1 and F > S:
        anchor_ids = np.arange(0, F, S)
        if anchor_ids[-1] != F - 1:
            anchor_ids = np.append(anchor_ids, F - 1)
        a = torch.as_tensor(anchor_ids, device=device)
        xa = rigid_init(prob, opts, obs[a], maskf[a])
        for scale in (10.0, 5.0, 1.0):  # first-frame schedule, chmosh.py:637
            xa, _ = run(xa, aux_for(a, scale), step1_mask, opts.e_3_anneal,
                        dl_opts)
        xa, _ = run(xa, aux_for(a), step2_mask, 1e-2, dl_opts)
        seg = np.minimum(np.searchsorted(anchor_ids, np.arange(F), "right") - 1,
                         len(anchor_ids) - 2)
        lo = anchor_ids[seg]
        hi = anchor_ids[seg + 1]
        alpha = torch.as_tensor(
            ((np.arange(F) - lo) / np.maximum(hi - lo, 1)).astype(np.float32),
            device=device)
        x = _interp_x(xa, torch.as_tensor(seg, device=device),
                      torch.as_tensor(seg + 1, device=device), alpha, model)
    else:
        x = rigid_init(prob, opts, obs, maskf)
        for scale in (10.0, 5.0, 1.0):
            x, _ = run(x, aux_for(None, scale), step1_mask, opts.e_3_anneal,
                       dl_opts)

    x, _ = run(x, aux_full, step1_mask, 1e-2, dl_opts)      # step 1
    x, _ = run(x, aux_full, step2_mask, 1e-2, dl_opts)      # step 2

    # ---- pass B: Jacobi smoothing sweeps ------------------------------------
    for _ in range(opts.smoothing_sweeps):
        x, _ = run(x, aux_full, step2_mask, 1e-2, dl_opts, use_velo=True)

    iters = torch.zeros((F,), dtype=torch.int32, device=device)
    if opts.e_3_polish is not None:
        use_velo = opts.smoothing_sweeps > 0 and F > 2
        x, iters = run(x, aux_full, step2_mask, opts.e_3_polish, dl_polish,
                       use_velo=use_velo)
    return _finalize(prob, opts, x, iters, obs, maskf, syncs)


def _finalize(prob, opts, x, iters, markers_obs, maskf, syncs) -> StageIIResult:
    model = prob.sub_model
    P = model.pose_dof
    pose = x[:, 3:3 + P]
    sim = simulate_markers(prob, opts, x)
    err = torch.sqrt(torch.sum((sim - markers_obs) ** 2, -1)) * maskf
    data_err = torch.sum(err, -1) / torch.clamp(torch.sum(maskf, 1), min=1.0)
    return StageIIResult(trans=x[:, :3], pose=pose,
                         fullpose=fullpose_from_pose(model, pose),
                         extra=x[:, 3 + P:], markers_sim=sim,
                         data_err=data_err, iterations=iters,
                         host_syncs=syncs)
