"""Stage II — per-frame pose (+trans) estimation, batched over frames.

Port of `moshpp_tpu/pipeline/stageii.py`: the `mosh_stageii_solve`
schedule for every family the JAX package solves (SMPL, SMPL+H, SMPL-X,
MANO, the SMAL horse and dog, and a rigid object embedded as a one-joint
model, `models/object_model.py`), with a body prior that is a GMM, a
callable on one frame's body slice (the horse's), or none, on a contiguous
or a gathered pose slice (the dog's 93 of 105 dofs), and per-frame extra
shape dims riding shapedirs columns: with `optimize_dynamics` DMPL
soft-tissue coefficients (columns [num_betas, num_betas + num_dmpls)), with
`optimize_face` expressions (columns from `expr_start`, SMPL-X's 300) and
the jaw. Any number of them: more than 16 take the marker kernels' tiled
route. Sequences longer than `chunk_frames` solve in overlapping chunks,
each kept to its interior, optionally checkpointed to `checkpoint_dir` and
resumed from there. The frame axis is data-parallel exactly as in the JAX
package:

  pass A: every S-th frame (anchor) gets the reference's first-frame
    treatment (rigid init, annealed prior solves [10w, 5w, w], a full-pose
    solve); the frames in between start from per-joint quaternion slerps
    between anchors; then all frames get step 1 (trans + body) and step 2
    (full pose);
  pass B: Jacobi smoothing sweeps re-create the sequential velocity term
    pose_t ~ 2 pose_{t-1} - pose_{t-2}; a tight polish solve ends it.

Each phase is one batched dogleg solve (`solver/gauss_newton.py`). Its
Gauss-Newton system is assembled directly: the marker rows and their exact
Jacobian from the marker kernels (`ops/marker_jac.py`), weighted by the
data weights in a torch pass or, with `fold_weights`, inside the marker
kernel (`marker_resid_and_wjac`); the normal equations B = JdᵀJd as one
float32 `torch.bmm` with TF32 off, the prior and regularizers as analytic
blocks. The direction is the fused dogleg kernel
(`solver/pcg.py`) in PCG phases and a batched Cholesky otherwise; on CUDA
the polish runs deep PCG through the kernel.

Telemetry: `return_report=True` adds a `StageIIReport` (each phase's mean
per-term energies before and after it, and its mean iterations), computed
on the device beside the solve and read once at its end; `on_phase` reads
each phase's x and simulated markers to the host. Without them a solve
launches and syncs as it would with neither. Under `torch.profiler` the
solve opens the spans of `utils/spans.py` (`stageii.solve`, a
`stageii.phase.<name>` a phase, the system's data rows, normal equations,
prior and cost, the dogleg's steps, direction, post-step and compaction),
and the solver counts its frame-iterations in `kernels.COUNTS.frames`;
with no profiler recording a span costs under a microsecond.

On a mesh (`mesh=`, a `parallel.FrameMesh`) each phase's dogleg solve runs
on contiguous shards of the frames, each shard on its device from a host
thread of its own (`_Shards`, the JAX package's `shard_map` schedule,
`moshpp_tpu/pipeline/stageii.py:957-1031`): compaction and termination are
shard-local, and the frame couplings (the velocity anchors, the rigid
init, the slerps between anchors, the report and the finalize) run on the
global frames on the problem's device. Across processes (`parallel/
multihost.py`) a rank solves its own shards and x is all-gathered after
every phase.

The inspection layer beside the solve: `make_stageii_residual` gives one
frame's least-squares rows through the plain forward model (their
`jacfwd` derives the system a second way), and `stageii_system_probe`
assembles one (f, g, B) at the rigid init, shard by shard on a mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import types
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from moshpp_torch.models.body_model import (MODEL_TYPE_INFO, SurfaceModel,
                                            fullpose_from_pose, lbs_forward,
                                            pose_part_ids)
from moshpp_torch.markers.vids import smplx_eyeball_mask
from moshpp_torch.ops.marker_jac import (MarkerJacTables,
                                         marker_resid_and_wjac, marker_sim,
                                         marker_sim_and_jacobian,
                                         prepare_marker_jac_tables, split_x)
from moshpp_torch.ops.marker_transform import (MarkerFrameIndices,
                                               marker_coeffs,
                                               reconstruct_markers,
                                               select_frame_indices)
from moshpp_torch.ops.rigid_align import kabsch
from moshpp_torch.ops.rodrigues import rodrigues_inverse, slerp_axis_angle
from moshpp_torch.priors.gmm import (MaxMixturePrior, gmm_prior_residual,
                                     select_component)
from moshpp_torch.solver.gauss_newton import (JAC_PRECISIONS, DoglegOptions,
                                              GNSystem, batched_system_solve,
                                              check_choice, fp32_matmul)
from moshpp_torch.solver.graphs import IterationGraphs
from moshpp_torch.utils import spans
from moshpp_torch.utils.spans import span, spanned

# the JAX package's `jac_backend` values (moshpp_tpu/pipeline/stageii.py:136)
JAC_BACKENDS = ("auto", "pallas", "xla")

NUM_TRAIN_MARKERS = 46.0  # weight-normalization constant (chmosh.py:460)

# the report's phase slots: the anchor pass's three annealed solves and its
# full-pose solve, step 1, step 2, the smoothing sweeps as one, the polish
STAGEII_PHASE_NAMES = ("anneal10", "anneal5", "anneal1", "anchor_step2",
                       "step1", "step2", "sweeps", "polish")

DEFAULT_STAGEII_WEIGHTS = {
    # smplh/smplx table, support_data/conf/moshpp_conf.yaml:118-125
    "data": 400.0, "velo": 2.5, "dmpl": 1.0, "expr": 1.0, "poseB": 1.6,
    "poseH": 1.0, "poseF": 1.0, "annealing": 2.5,
    # extra velocity weight on the hand-PCA dofs (1.0 = off)
    "velo_hands": 1.0,
}


@dataclasses.dataclass(frozen=True)
class StageIIOptions:
    optimize_fingers: bool = False
    optimize_face: bool = False       # jaw and expressions
    optimize_toes: bool = False
    optimize_dynamics: bool = False   # DMPL extras
    num_betas: int = 16
    num_dmpls: int = 8
    num_expressions: int = 10
    expr_start: int = 300             # SMPL-X's betas_expr_start_id
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
    # sequences longer than this solve in overlapping chunks (0 = one batch
    # whatever the length): each chunk covers [s - chunk_halo, s +
    # chunk_frames + chunk_halo), edge-padded to that one width, and keeps
    # its interior [s, s + chunk_frames); the halo gives seam frames the
    # velocity sweeps' context on both sides
    chunk_frames: int = 16384
    chunk_halo: int = 32
    # resume long chunked runs: each solved chunk's interior is written here
    # (an atomic npz fingerprinted by inputs and options), and a rerun skips
    # the chunks it finds
    checkpoint_dir: Optional[str] = None
    # fold the per-frame data weights and the residual into the marker
    # kernel (skips the (F, M, 3, D) weighting pass over the Jacobian)
    fold_weights: bool = False
    weights: Optional[Dict[str, float]] = None
    knn_k: int = 8
    # The JAX package's Jacobian precision (one of `JAC_PRECISIONS`) and its
    # data-block backend ('auto' | 'pallas' | 'xla'): both are taken and
    # checked for the JAX package's callers, and both are no-ops here. The
    # port computes J by its kernels in float32 and B as one float32 `bmm`
    # with TF32 off, at least JAX's 'highest', and the same function
    # whatever the backend.
    jac_precision: str = "high"
    jac_backend: str = "auto"

    def __post_init__(self):
        check_choice("jac_precision", self.jac_precision, JAC_PRECISIONS)
        check_choice("jac_backend", self.jac_backend, JAC_BACKENDS)

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
    extra: torch.Tensor         # (F, E) DMPLs or expressions (E may be 0)
    markers_sim: torch.Tensor   # (F, M, 3)
    data_err: torch.Tensor      # (F,) mean distance over observed markers (m)
    iterations: torch.Tensor    # (F,) iterations of the final (polish) solve
    host_syncs: int             # loop-condition reads over all phases


def _num_extra(opts: StageIIOptions) -> int:
    if opts.optimize_dynamics:
        return opts.num_dmpls
    if opts.optimize_face:
        return opts.num_expressions
    return 0


def _extra_start(model: SurfaceModel, opts: StageIIOptions) -> int:
    """First shapedirs column of the extra dims: DMPLs right after the
    betas; expressions at `expr_start`, or as far on as the model's
    shapedirs allow."""
    if opts.optimize_dynamics:
        return opts.num_betas
    return min(opts.expr_start, model.num_shape_dirs - opts.num_expressions)


def _betas_for_lbs(prob: StageIIProblem, opts: StageIIOptions,
                   extra: torch.Tensor) -> torch.Tensor:
    """Shape coefficients seen by LBS: the subject's betas (B',) or, with
    E extra dims, (N, start + E) per frame: the betas, zeros, and the extras
    in their shapedirs columns [start, start + E)."""
    base = prob.betas[:opts.num_betas]
    E = _num_extra(opts)
    if not E:
        return base
    N = extra.shape[0]
    if opts.optimize_dynamics:
        return torch.cat([base.expand(N, -1), extra], dim=1)
    # built by concatenation, not written in place, so that
    # `torch.func.vmap`/`jacfwd` trace it (`make_stageii_residual`)
    es = _extra_start(prob.sub_model, opts)
    cols = [base[:es].expand(N, -1)]
    if es > cols[0].shape[1]:
        cols.append(extra.new_zeros((N, es - cols[0].shape[1])))
    return torch.cat(cols + [extra], dim=1)


def _problem(sub_model, local, coeffs, betas, opts) -> StageIIProblem:
    dev = sub_model.device
    local = torch.as_tensor(np.asarray(local), dtype=torch.long, device=dev)
    indices = MarkerFrameIndices(local[:, 0], local[:, 1], local[:, 2])
    coeffs = torch.as_tensor(coeffs, dtype=torch.float32, device=dev)
    betas = torch.as_tensor(betas, dtype=torch.float32, device=dev)
    es = _extra_start(sub_model, opts)
    tables = prepare_marker_jac_tables(
        sub_model, indices, coeffs, betas[:opts.num_betas],
        extra_cols=range(es, es + _num_extra(opts)))
    return StageIIProblem(sub_model, indices.c0, indices.c1, indices.c2,
                          coeffs, betas, tables)


def prepare_stageii_problem(model: SurfaceModel,
                            betas: np.ndarray,
                            markers_latent: np.ndarray,
                            opts: StageIIOptions = StageIIOptions(),
                            exclude_vertex_mask: Optional[np.ndarray] = None,
                            *, device) -> StageIIProblem:
    """Freeze the stage-i outputs (numpy or tensors, e.g. a `StageIResult`'s
    `betas` and `markers_latent`) into a solver context on `device`.

    The latent markers' local frames come from the canonical shaped body;
    the model is then gathered to the union of frame vertices. Vertices in
    `exclude_vertex_mask` (V,) bool are never frame vertices; by default the
    SMPL-X eyeballs, as in the JAX package (none unless V = 10475).
    """
    model = model.to(device)
    betas = torch.as_tensor(betas, dtype=torch.float32, device=device)
    lat = torch.as_tensor(markers_latent, dtype=torch.float32, device=device)
    nb = betas.shape[-1]
    can_verts = model.v_template + torch.einsum(
        "vcb,b->vc", model.shapedirs[..., :nb], betas)
    if exclude_vertex_mask is None:
        exclude_vertex_mask = smplx_eyeball_mask(can_verts.shape[0])
    excl = torch.as_tensor(np.asarray(exclude_vertex_mask, bool),
                           device=device)
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
    return _problem(sub_model.to(device), np.array(frame_idx),
                    np.array(coeffs, np.float32),
                    np.array(betas, np.float32), opts)


def simulate_markers(prob: StageIIProblem, opts: StageIIOptions,
                     x: torch.Tensor) -> torch.Tensor:
    """Markers (N, M, 3) from packed (N, 3 + P + E) parameters, through the
    plain forward model (not the kernels), as the JAX package's outputs
    are."""
    trans, pose, extra = split_x(x, prob.sub_model.pose_dof)
    verts = lbs_forward(prob.sub_model, pose,
                        _betas_for_lbs(prob, opts, extra), trans)
    return reconstruct_markers(verts, prob.indices, prob.coeffs)


class _TermSpec(NamedTuple):
    body_ids: Optional[np.ndarray]        # x-indices of the prior's pose slice
    body_rng: Optional[Tuple[int, int]]   # the same as a range, if contiguous
    finger_rng: Optional[Tuple[int, int]]  # x-range of the hand-PCA tail
    face_rng: Optional[Tuple[int, int]]   # x-range of the jaw


def _term_spec(prob: StageIIProblem, opts: StageIIOptions,
               model_type: str) -> _TermSpec:
    info = MODEL_TYPE_INFO[model_type]
    P = prob.sub_model.pose_dof
    # the prior acts on the full (toes included) body slice, chmosh.py:614
    prior_pose = [i for i in pose_part_ids(model_type, optimize_toes=True)["body"]
                  if i >= 3]
    body_ids = body_rng = None
    if prior_pose:
        body_ids = 3 + np.asarray(prior_pose, np.int64)
        if np.all(np.diff(body_ids) == 1):
            body_rng = (int(body_ids[0]), int(body_ids[-1]) + 1)
    finger_rng = ((3 + info.body_pose_dof, 3 + P)
                  if (opts.optimize_fingers and info.has_hands) else None)
    face = pose_part_ids(model_type, optimize_toes=opts.optimize_toes)["face"]
    face_rng = ((3 + face[0], 3 + face[-1] + 1)
                if (opts.optimize_face and face) else None)
    return _TermSpec(body_ids, body_rng, finger_rng, face_rng)


def _velo_weight_vec(prob, opts, spec, device) -> torch.Tensor:
    """Per-dof velocity weights over the pose vector (hand-PCA dofs scaled
    by `velo_hands`)."""
    P = prob.sub_model.pose_dof
    w = np.full(P, float(opts.wt("velo")), np.float32)
    vh = float(opts.wt("velo_hands"))
    if vh != 1.0 and spec.finger_rng is not None:
        w[spec.finger_rng[0] - 3:spec.finger_rng[1] - 3] *= vh
    return torch.as_tensor(w, device=device)


# a body prior: a max-mixture GMM, or a callable on one frame's body slice,
# (bw,) -> (R,), whose rows the system squares (the horse's)
Prior = Union[MaxMixturePrior, Callable[[torch.Tensor], torch.Tensor]]
CALLABLE_PRIOR_RANGE = spans.CALLABLE_PRIOR


def make_stageii_residual(prob: StageIIProblem,
                          opts: StageIIOptions,
                          prior: Optional[Prior],
                          model_type: str):
    """The least-squares rows of one frame, r(x (D,), aux) -> (R,), whose
    sum of squares is the cost `make_stageii_system` assembles
    (`moshpp_tpu/pipeline/stageii.py::make_stageii_residual`): the masked
    data rows times `wt_data` through the plain forward model
    (`simulate_markers`), the body prior (a GMM's rows or the callable's),
    the hand, jaw and expression magnitudes, the DMPL magnitude and anchor,
    and the velocity anchor, in the JAX package's row order.

    aux holds one frame's values: markers (M, 3), mask (M,), wt_data,
    anneal, wt_pose_scale (), velo_anchor (P,), velo_on () and, with DMPL
    dims, extra_anchor (E,), extra_on (). No kernel runs here: the rows
    trace under `torch.func.vmap`/`jacfwd`, so that
    `solver.gauss_newton._residual_system(residual, batched_aux=True)` is a
    second, independent derivation of the system (the generic-solver path).
    """
    spec = _term_spec(prob, opts, model_type)
    wt = opts.wt
    P = prob.sub_model.pose_dof
    E = _num_extra(opts)
    velo_w = _velo_weight_vec(prob, opts, spec, prob.device)
    ids = (None if prior is None or spec.body_ids is None
           else torch.as_tensor(spec.body_ids, device=prob.device))
    is_gmm = isinstance(prior, MaxMixturePrior)

    def residual(x: torch.Tensor, aux) -> torch.Tensor:
        pose, extra = x[3:3 + P], x[3 + P:]
        sim = simulate_markers(prob, opts, x[None])[0]
        terms = [((sim - aux["markers"]) * aux["mask"][:, None]).reshape(-1)
                 * aux["wt_data"]]
        if ids is not None:
            w = wt("poseB") * aux["anneal"] * aux["wt_pose_scale"]
            xb = x[ids]
            terms.append((gmm_prior_residual(prior, xb[None])[0] if is_gmm
                          else prior(xb)) * w)
        if spec.finger_rng is not None:
            s, e = spec.finger_rng
            terms.append(x[s:e] * (wt("poseH") * aux["anneal"]))
        if spec.face_rng is not None:
            s, e = spec.face_rng
            terms.append(x[s:e] * (wt("poseF") * aux["anneal"]))
            terms.append(extra * wt("expr"))
        if opts.optimize_dynamics and E:
            terms.append(extra * wt("dmpl"))
            terms.append((extra - aux["extra_anchor"])
                         * (6.0 * aux["extra_on"]))
        terms.append((pose - aux["velo_anchor"]) * (velo_w * aux["velo_on"]))
        return torch.cat(terms)

    return residual


def make_stageii_system(prob: StageIIProblem,
                        opts: StageIIOptions,
                        prior: Optional[Prior],
                        model_type: str) -> GNSystem:
    """Batched Gauss-Newton system (x (N, D), aux) -> (f, g, B (N, D, D)).

    aux values carry a leading N: markers (N, M, 3), mask (N, M), wt_data,
    anneal, wt_pose_scale (N,), velo_anchor (N, P), velo_on (N,) and, with
    DMPL dims, extra_anchor (N, E), extra_on (N,).

    A GMM prior adds its selected component's quadratic form; a callable
    prior r(xb) adds |w r|^2, w^2 J^T r and w^2 J^T J with J = dr/dxb, rows
    and Jacobian of all N frames from one `vmap(jacfwd)`. The prior's slice
    is a range of x or, where the family's prior covers a subset of joints
    (the dog), gathered by index.
    """
    spec = _term_spec(prob, opts, model_type)
    model = prob.sub_model
    tables = prob.tables
    P = model.pose_dof
    E = _num_extra(opts)
    D = 3 + P + E
    wt = opts.wt
    velo_w = _velo_weight_vec(prob, opts, spec, prob.device)
    use_prior = prior is not None and spec.body_ids is not None
    is_gmm = isinstance(prior, MaxMixturePrior)
    if use_prior and is_gmm:
        # per-component precision quadratic 0.5 L Lᵀ, built once
        PP = 0.5 * torch.einsum("kde,kfe->kdf", prior.chols, prior.chols)
    elif use_prior:
        def rows_twice(xb):
            r = prior(xb)
            return r, r

        prior_rows = torch.func.vmap(prior)
        # the rows ride out as jacfwd's aux: one pass gives rows and Jacobian
        prior_jac = torch.func.vmap(torch.func.jacfwd(rows_twice,
                                                      has_aux=True))
    ids = (None if spec.body_ids is None or spec.body_rng is not None
           else torch.as_tensor(spec.body_ids, device=prob.device))

    def body(x):
        """The prior's pose slice of x (N, D)."""
        if ids is None:
            return x[:, spec.body_rng[0]:spec.body_rng[1]]
        return x[:, ids]

    def prior_terms(x, aux, f, cost_only: bool):
        """f plus the prior's cost; unless `cost_only` also its gradient
        (N, bw) and block (N, bw, bw) on the prior's slice."""
        w = wt("poseB") * aux["anneal"] * aux["wt_pose_scale"]
        w2 = w * w
        xb = body(x)
        if is_gmm:
            k = select_component(prior, xb)
            q = xb - prior.means[k]
            PPk = PP[k]
            gq = torch.bmm(PPk, q[..., None])[..., 0]
            f = f + w2 * (torch.sum(q * gq, -1) + prior.sqrt_neg_log_w[k] ** 2)
            if cost_only:
                return f, None, None
            return f, w2[:, None] * gq, w2[:, None, None] * PPk
        # a profiler range (tools/profile_torch_slice.py reads its share);
        # the slice made contiguous: on a strided one vmap(jacfwd)'s tangent
        # product runs as cuBLAS's batched GEMV, ~5x slower on the H100
        xb = xb.contiguous()
        with span(CALLABLE_PRIOR_RANGE):
            if cost_only:
                rp = prior_rows(xb)
                return f + w2 * torch.sum(rp * rp, -1), None, None
            Jp, rp = prior_jac(xb)                     # (N, R, bw), (N, R)
            f = f + w2 * torch.sum(rp * rp, -1)
            Jt = Jp.transpose(1, 2)
            gb = w2[:, None] * torch.bmm(Jt, rp[..., None])[..., 0]
            return f, gb, w2[:, None, None] * torch.bmm(Jt, Jp)

    def quad(x, aux, f, cost_only: bool):
        """Prior and regularizer terms: f, and unless `cost_only` their
        gradient (N, D), diagonal (N, D) and body-prior block."""
        g = dvec = ppw = None
        if not cost_only:
            g = torch.zeros_like(x)
            dvec = torch.zeros_like(x)
        if use_prior:
            f, gb, ppw = prior_terms(x, aux, f, cost_only)
            if not cost_only:
                if ids is None:
                    g[:, spec.body_rng[0]:spec.body_rng[1]] += gb
                else:
                    g[:, ids] += gb

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
        if spec.face_rng is not None:
            # jaw and expression magnitudes (JAX `_quad_smalls`)
            s, e = spec.face_rng
            wf = (wt("poseF") * aux["anneal"])[:, None]
            f = diag(f, s, e, x[:, s:e], wf)
            f = diag(f, 3 + P, D, x[:, 3 + P:], wt("expr"))
        if opts.optimize_dynamics and E:
            # DMPL magnitude and its extrapolation anchor
            extra = x[:, 3 + P:]
            f = diag(f, 3 + P, D, extra, wt("dmpl"))
            f = diag(f, 3 + P, D, extra - aux["extra_anchor"],
                     6.0 * aux["extra_on"][:, None])
        pose = x[:, 3:3 + P]
        f = diag(f, 3, 3 + P, pose - aux["velo_anchor"],
                 velo_w[None, :] * aux["velo_on"][:, None])
        return f, g, dvec, ppw

    def data_weights(aux):
        return aux["mask"] * aux["wt_data"][:, None]               # (N, M)

    @spanned(spans.ASSEMBLY)
    def system_fn(x, aux):
        N = x.shape[0]
        with span(spans.DATA_ROWS):
            wrow = data_weights(aux)
            if opts.fold_weights:
                rd, Jd = marker_resid_and_wjac(model, tables, x,
                                               aux["markers"], wrow)
            else:
                sim, Jm = marker_sim_and_jacobian(model, tables, x)
                rd = (sim - aux["markers"]) * wrow[..., None]
                Jd = Jm * wrow[..., None, None]
        with span(spans.NORMAL_EQ):
            f0 = torch.sum(rd * rd, dim=(1, 2))
            g0 = torch.sum(Jd * rd[..., None], dim=(1, 2))
            J2 = Jd.reshape(N, -1, D)
            P0 = 0.5 * torch.bmm(J2.transpose(1, 2), J2)
        with span(spans.PRIOR):
            f, gq, dvec, ppw = quad(x, aux, f0, cost_only=False)
        with span(spans.NORMAL_EQ):
            # symmetrize as the JAX assembly does (B = P0 + P0ᵀ): the
            # direction kernel reads only B's leading index
            B = P0 + P0.transpose(1, 2) + torch.diag_embed(dvec)
            if ppw is not None:
                if ids is None:
                    s, e = spec.body_rng
                    B[:, s:e, s:e] += ppw
                else:
                    # the ids are distinct: the gathered add is a plain add
                    B[:, ids[:, None], ids[None, :]] += ppw
            return f, g0 + gq, B

    @spanned(spans.COST)
    def cost_fn(x, aux):
        rd = (marker_sim(model, tables, x) - aux["markers"]) * data_weights(
            aux)[..., None]
        return quad(x, aux, torch.sum(rd * rd, dim=(1, 2)), cost_only=True)[0]

    return GNSystem(system_fn, cost_fn)


def report_term_names(prob: StageIIProblem, opts: StageIIOptions, prior,
                      model_type: str) -> Tuple[str, ...]:
    """The report's terms in the JAX package's order: sorted by name, as
    JAX's pytree flattening orders the energies' dict."""
    spec = _term_spec(prob, opts, model_type)
    names = ["data"]
    if prior is not None and spec.body_ids is not None:
        names.append("poseB")
    if spec.finger_rng is not None:
        names.append("poseH")
    if spec.face_rng is not None:
        names += ["poseF", "expr"]
    if opts.optimize_dynamics and _num_extra(opts):
        names += ["dmpl", "dmpl_anchor"]
    return tuple(sorted(names + ["velo"]))


# the JAX package's name of the report's term names
# (`moshpp_tpu/pipeline/stageii.py::report_arrays_spec`)
report_arrays_spec = report_term_names


def stageii_term_energies(prob: StageIIProblem, opts: StageIIOptions,
                          prior: Optional[Prior], model_type: str):
    """The per-term sum-of-squares breakdown (x (N, D), aux) -> {term: (N,)}
    of each frame, keyed in `report_term_names` order
    (`moshpp_tpu/pipeline/stageii.py::stageii_term_energies`; the
    reference's per-objective log, chmosh.py:408-417, 662-707): the
    data rows through the plain forward model, the body prior, the hand,
    jaw and expression magnitudes, the DMPL magnitude and anchor, and the
    velocity term, as the solve's system weighs them."""
    spec = _term_spec(prob, opts, model_type)
    wt = opts.wt
    P = prob.sub_model.pose_dof
    velo_w = _velo_weight_vec(prob, opts, spec, prob.device)
    names = report_term_names(prob, opts, prior, model_type)
    ids = (None if spec.body_ids is None else
           torch.as_tensor(spec.body_ids, device=prob.device))
    prior_rows = (None if prior is None or isinstance(prior, MaxMixturePrior)
                  else torch.func.vmap(prior))

    def sq(v):
        return torch.sum(v * v, dim=-1)

    def energies(x, aux):
        pose, extra = x[:, 3:3 + P], x[:, 3 + P:]
        sim = simulate_markers(prob, opts, x)
        rdata = (sim - aux["markers"]) * (aux["mask"]
                                          * aux["wt_data"][:, None])[..., None]
        out = {"data": torch.sum(rdata * rdata, dim=(1, 2))}
        if "poseB" in names:
            w = wt("poseB") * aux["anneal"] * aux["wt_pose_scale"]
            xb = x[:, ids]
            rp = (gmm_prior_residual(prior, xb) if prior_rows is None
                  else prior_rows(xb))
            out["poseB"] = sq(rp * w[:, None])
        if "poseH" in names:
            s, e = spec.finger_rng
            out["poseH"] = sq(x[:, s:e]
                              * (wt("poseH") * aux["anneal"])[:, None])
        if "poseF" in names:
            s, e = spec.face_rng
            out["poseF"] = sq(x[:, s:e]
                              * (wt("poseF") * aux["anneal"])[:, None])
            out["expr"] = sq(extra * wt("expr"))
        if "dmpl" in names:
            out["dmpl"] = sq(extra * wt("dmpl"))
            out["dmpl_anchor"] = sq((extra - aux["extra_anchor"])
                                    * (6.0 * aux["extra_on"])[:, None])
        out["velo"] = sq((pose - aux["velo_anchor"])
                         * (velo_w[None, :] * aux["velo_on"][:, None]))
        return {k: out[k] for k in names}

    return energies


class StageIIReport(NamedTuple):
    """Per-phase telemetry (reference-style per-objective logging,
    chmosh.py:408-417, 662-707), numpy."""
    phase_names: Tuple[str, ...]
    term_names: Tuple[str, ...]
    energies_before: np.ndarray   # (n_phases, n_terms) mean over frames
    energies_after: np.ndarray    # (n_phases, n_terms)
    iterations: np.ndarray        # (n_phases,) mean dogleg iterations/frame
    # host syncs of each of this process's shards over all phases (a solve
    # on a mesh; empty otherwise)
    shard_syncs: Tuple[int, ...] = ()

    def format_table(self) -> str:
        hdr = "phase        iters  " + "  ".join(
            f"{t:>10s}" for t in self.term_names)
        rows = [hdr]
        for i, name in enumerate(self.phase_names):
            vals = "  ".join(f"{self.energies_after[i, j]:10.3e}"
                             for j in range(len(self.term_names)))
            rows.append(f"{name:12s} {self.iterations[i]:5.1f}  {vals}")
        return "\n".join(rows)


def _param_masks(model: SurfaceModel, opts: StageIIOptions, model_type: str,
                 device):
    """(step1, step2) binary masks over the packed x vector."""
    info = MODEL_TYPE_INFO[model_type]
    parts = pose_part_ids(model_type, optimize_toes=opts.optimize_toes)
    P = model.pose_dof
    step1 = np.zeros(3 + P + _num_extra(opts), np.float32)
    step1[:3] = 1.0
    for i in parts["root"] + parts["body"]:
        step1[3 + i] = 1.0
    if model_type == "mano":
        step1[3 + info.body_pose_dof: 3 + P] = 1.0
    step2 = step1.copy()
    if opts.optimize_fingers and info.has_hands:
        step2[3 + info.body_pose_dof: 3 + P] = 1.0
    if opts.optimize_face:
        for i in parts["face"]:
            step2[3 + i] = 1.0
        step2[3 + P:] = 1.0
    if opts.optimize_dynamics:
        step2[3 + P:] = 1.0
    t = lambda a: torch.as_tensor(a, device=device)
    return t(step1), t(step2)


@spanned(spans.RIGID_INIT)
def rigid_init(prob: StageIIProblem, opts: StageIIOptions,
               markers_obs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-frame rigid initialization about the root joint: packed x0 (F, D)."""
    model = prob.sub_model
    D = 3 + model.pose_dof + _num_extra(opts)
    F = markers_obs.shape[0]
    dev = markers_obs.device
    sim_rest = simulate_markers(
        prob, opts, torch.zeros((1, D), device=dev))[0]         # (M, 3)
    nb = opts.num_betas
    betas = prob.betas[:nb]
    j0 = model.joint_template[0] + model.joint_shapedirs[0, :, :betas.shape[0]] @ betas
    rot, t = kabsch(sim_rest.expand(F, -1, -1), markers_obs, mask)
    rv = rodrigues_inverse(rot)
    trans = t + rot @ j0 - j0
    x = torch.zeros((F, D), dtype=torch.float32, device=dev)
    x[:, :3] = trans
    x[:, 3:6] = rv
    return x


def _interp_x(xa: torch.Tensor, seg_lo: torch.Tensor, seg_hi: torch.Tensor,
              alpha: torch.Tensor, model: SurfaceModel) -> torch.Tensor:
    """Rotation-aware interpolation between anchor solves: joint axis-angles
    by per-joint quaternion slerp, the rest (hand-PCA coefficients,
    translation, extra dims) linearly."""
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


def _velo_aux(x: torch.Tensor, P: int, dynamics: bool) -> dict:
    """Velocity extrapolation anchors 2 x_{t-1} - x_{t-2} of the pose and,
    with DMPL `dynamics`, of the extra dims, and their on-flags (frames
    >= 2). Expressions get no anchor, as in the JAX package."""
    F = x.shape[0]

    def anchor(v):
        return (2.0 * torch.roll(v, 1, 0) - torch.roll(v, 2, 0)) * on[:, None]

    on = (torch.arange(F, device=x.device) >= 2).to(torch.float32)
    out = {"velo_anchor": anchor(x[:, 3:3 + P]), "velo_on": on}
    if dynamics and x.shape[1] > 3 + P:
        out.update(extra_anchor=anchor(x[:, 3 + P:]), extra_on=on)
    return out


@spanned(spans.SOLVE)
def mosh_stageii_solve(prob: StageIIProblem,
                       opts: StageIIOptions,
                       markers_obs,
                       mask,
                       prior: Optional[Prior] = None,
                       model_type: Optional[str] = None,
                       return_report: bool = False,
                       on_phase=None,
                       mesh=None,
                       *, device):
    """Solve all frames on `device` (the problem's device).

    markers_obs (F, M, 3) in meters and mask (F, M) bool, numpy or tensors.
    More than `opts.chunk_frames` frames solve in chunks (`_solve_chunked`).

    `on_phase(phase_name, x, markers_sim)` is an optional per-phase hook
    (numpy arguments; the headless stand-in for the reference's live
    visualization at verbosity > 1, chmosh.py:516-519), e.g.
    `tools/visualization.phase_snapshot_writer`. It reads each phase's
    result to the host; leave it None in production.

    `mesh` (a `parallel.FrameMesh`) shards each phase's dogleg solve over
    the mesh's devices (and, for a mesh of `parallel.global_frame_mesh`,
    over the processes of its group); the rest of the schedule stays on
    `device`. `host_syncs` is then the sum over this process's shards, and
    the report's `shard_syncs` gives each shard's.

    Returns a StageIIResult, or (StageIIResult, StageIIReport) when
    `return_report=True`.
    """
    device = torch.device(device)
    if prob.device.type != device.type:
        raise ValueError(f"problem lives on {prob.device}, asked for {device}")
    _check_mesh(mesh)
    model_type = model_type or prob.sub_model.model_type
    if opts.chunk_frames and markers_obs.shape[0] > opts.chunk_frames:
        return _solve_chunked(prob, opts, markers_obs, mask, prior,
                              model_type, device, return_report, on_phase,
                              mesh)
    # the dogleg iterations' CUDA graphs of this call, shared by its phases
    # and dropped when it returns
    with fp32_matmul(), IterationGraphs() as graphs:
        return _solve(prob, opts, markers_obs, mask, prior, model_type,
                      device, return_report, on_phase, mesh, graphs)


def _check_mesh(mesh) -> None:
    """TypeError unless `mesh` is None or a `parallel.FrameMesh`."""
    if mesh is not None:
        from moshpp_torch.parallel.sharding import FrameMesh
        if not isinstance(mesh, FrameMesh):
            raise TypeError(f"mesh: expected a parallel.FrameMesh, got "
                            f"{type(mesh).__name__}")


def _chunk_fingerprint(prob: StageIIProblem, inner_opts: StageIIOptions,
                       prior, model_type: str, obs_c: np.ndarray,
                       msk_c: np.ndarray) -> str:
    """Content hash tying a chunk checkpoint to its inputs: the padded
    window's observations and mask, the frozen problem (subset model,
    marker frames, coefficients, betas), a GMM prior's arrays, the family
    and every solver option. A stale checkpoint (edited mocap, other
    weights, another model) fails the compare and the chunk re-solves. A
    callable prior enters by its rows at a fixed probe point. The hash is
    this package's own: a checkpoint the JAX package wrote never matches,
    and re-solves."""
    h = hashlib.sha1(b"moshpp_torch stage-ii chunk v1")
    arrays = [getattr(prob.sub_model, f) for f in (
        "v_template", "shapedirs", "posedirs", "weights", "joint_template",
        "joint_shapedirs", "hands_components", "hands_mean")]
    arrays += [prob.frame_c0, prob.frame_c1, prob.frame_c2, prob.coeffs,
               prob.betas]
    body_ids = _term_spec(prob, inner_opts, model_type).body_ids
    if isinstance(prior, MaxMixturePrior):
        arrays += [prior.means, prior.chols, prior.sqrt_neg_log_w]
    elif prior is not None and body_ids is not None:
        arrays.append(prior(torch.linspace(-0.5, 0.5, len(body_ids),
                                           device=prob.device)))
    for a in arrays:
        h.update(a.detach().cpu().numpy().tobytes())
    h.update(repr((prob.sub_model.parents, prob.sub_model.skin_k, model_type,
                   dataclasses.replace(inner_opts, checkpoint_dir=None))
                  ).encode())
    h.update(obs_c.tobytes())
    h.update(msk_c.tobytes())
    return h.hexdigest()


_CKPT_REPORT_FIELDS = ("energies_before", "energies_after", "iterations")


def _chunk_ckpt_load(path: str, fingerprint: str, device,
                     return_report: bool):
    """(a chunk's saved interior on `device`, its report or None), or None
    when the file is missing, stale or unreadable, or was saved without the
    report a caller wants (the chunk then re-solves to get it). A loaded
    chunk counts no host syncs."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            if str(z["fingerprint"]) != fingerprint:
                return None
            if return_report and "report_energies_after" not in z:
                return None
            res = StageIIResult(
                *[torch.as_tensor(z[f], device=device)
                  for f in StageIIResult._fields[:-1]], host_syncs=0)
            rep = None
            if return_report:
                rep = StageIIReport(
                    phase_names=tuple(str(n) for n in z["report_phase_names"]),
                    term_names=tuple(str(n) for n in z["report_term_names"]),
                    **{f: z["report_" + f] for f in _CKPT_REPORT_FIELDS})
            return res, rep
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None      # truncated or corrupt: a crash mid-write


def _chunk_ckpt_save(path: str, fingerprint: str, piece: StageIIResult,
                     rep: Optional[StageIIReport]) -> None:
    """Write a chunk's interior (and its report, where there is one)
    atomically: a crash never leaves a partial file under the chunk's
    name."""
    arrays = {"fingerprint": np.asarray(fingerprint)}
    arrays.update({f: getattr(piece, f).detach().cpu().numpy()
                   for f in StageIIResult._fields[:-1]})
    if rep is not None:
        # "report_" prefix: StageIIResult and StageIIReport both have an
        # `iterations` field (per frame against per phase)
        arrays["report_phase_names"] = np.asarray(rep.phase_names)
        arrays["report_term_names"] = np.asarray(rep.term_names)
        arrays.update({"report_" + f: np.asarray(getattr(rep, f))
                       for f in _CKPT_REPORT_FIELDS})
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _solve_chunked(prob, opts, markers_obs, mask, prior, model_type,
                   device, return_report=False, on_phase=None, mesh=None):
    """Overlapping-chunk drive of `mosh_stageii_solve` for long sequences
    (`moshpp_tpu/pipeline/stageii.py:_solve_chunked`).

    Each chunk covers [s - H, s + C + H) and is edge-padded at the tail to
    the one window W = C + 2H, as in the JAX package: trajectories depend on
    the batch's shape, so every chunk solves at the same shape. Only the
    interior [s, s + C) of each solve is kept, so seam frames have H frames
    of velocity-sweep context on both sides. Results are concatenated on
    `device`; `host_syncs` is the sum over the chunks this call solved.
    With `checkpoint_dir`, each chunk's interior is saved as
    `chunk_{s:09d}.npz` and a rerun loads every chunk whose fingerprint
    matches (`_chunk_fingerprint`) instead of solving it.

    The report's energies are means over each chunk's padded window, merged
    weighted by the frames each chunk keeps, as in the JAX package: an
    approximation of the one-batch report (halo frames count in two
    windows, pad frames repeat the boundary frame).

    On a mesh W rounds up to a multiple of the mesh's shards, so that every
    chunk splits into equal shards, as in the JAX package."""
    F = markers_obs.shape[0]
    C, H = int(opts.chunk_frames), int(opts.chunk_halo)
    W = C + 2 * H
    if mesh is not None:
        W = -(-W // mesh.num_shards) * mesh.num_shards
    inner_opts = dataclasses.replace(opts, chunk_frames=0)
    obs = torch.as_tensor(markers_obs, dtype=torch.float32, device=device)
    msk = torch.as_tensor(mask, device=device).to(torch.bool)
    ckpt_dir = opts.checkpoint_dir
    if ckpt_dir:
        os.makedirs(ckpt_dir, exist_ok=True)

    def solve_chunk(s):
        """(the kept interior of the chunk from frame s, its report or
        None): loaded from its checkpoint where that matches, else
        solved."""
        lo, hi = max(0, s - H), min(F, s + C + H)
        obs_c, msk_c = obs[lo:hi], msk[lo:hi]
        pad = W - (hi - lo)
        if pad:
            # the window's last real frame repeated: the pad solves to that
            # boundary pose (a stationary tail for the velocity term) and,
            # but at the sequence's end, sits >= H frames from anything kept
            obs_c = torch.cat([obs_c, obs_c[-1:].expand(pad, -1, -1)])
            msk_c = torch.cat([msk_c, msk_c[-1:].expand(pad, -1)])
        path = fp = None
        if ckpt_dir:
            fp = _chunk_fingerprint(prob, inner_opts, prior, model_type,
                                    obs_c.cpu().numpy(), msk_c.cpu().numpy())
            path = os.path.join(ckpt_dir, f"chunk_{s:09d}.npz")
            cached = _chunk_ckpt_load(path, fp, device, return_report)
            if cached is not None:
                return cached
        out = mosh_stageii_solve(prob, inner_opts, obs_c, msk_c, prior=prior,
                                 model_type=model_type, device=device,
                                 return_report=return_report,
                                 on_phase=on_phase, mesh=mesh)
        res, rep = out if return_report else (out, None)
        take = slice(s - lo, s - lo + min(C, F - s))
        piece = StageIIResult(*[getattr(res, f)[take]
                                for f in StageIIResult._fields[:-1]],
                              host_syncs=res.host_syncs)
        if ckpt_dir:
            _chunk_ckpt_save(path, fp, piece, rep)
        return piece, rep

    pieces, reps = [], []
    for s in range(0, F, C):
        with span(spans.CHUNK):
            piece, rep = solve_chunk(s)
        pieces.append(piece)
        reps.append(rep)
    kept = [min(C, F - s) for s in range(0, F, C)]

    result = StageIIResult(
        *[torch.cat([getattr(p, f) for p in pieces])
          for f in StageIIResult._fields[:-1]],
        host_syncs=sum(p.host_syncs for p in pieces))
    if not return_report:
        return result
    w = np.asarray(kept, np.float64)[:, None, None] / F
    stack = lambda f: np.asarray([getattr(r, f) for r in reps])
    shard_syncs = [r.shard_syncs for r in reps if r.shard_syncs]
    return result, StageIIReport(
        phase_names=reps[0].phase_names, term_names=reps[0].term_names,
        energies_before=np.sum(stack("energies_before") * w, axis=0),
        energies_after=np.sum(stack("energies_after") * w, axis=0),
        iterations=np.sum(stack("iterations") * w[..., 0], axis=0),
        shard_syncs=tuple(int(v) for v in np.sum(shard_syncs, axis=0))
        if shard_syncs else ())


def _solve(prob, opts, markers_obs, mask, prior, model_type, device,
           return_report=False, on_phase=None, mesh=None, graphs=None):
    model = prob.sub_model
    obs = torch.as_tensor(markers_obs, dtype=torch.float32, device=device)
    maskf = torch.as_tensor(mask, device=device).to(torch.float32)
    F, M = maskf.shape
    P = model.pose_dof
    # DMPL dims carry extrapolation anchors; expressions have none
    n_anchored = _num_extra(opts) if opts.optimize_dynamics else 0
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
        aux = {"markers": pick(obs), "mask": pick(maskf),
               "wt_data": pick(wt_data), "anneal": pick(anneal),
               "wt_pose_scale": torch.full((n,), scale, device=device),
               "velo_anchor": torch.zeros((n, P), device=device),
               "velo_on": z}
        if n_anchored:
            aux.update(extra_anchor=torch.zeros((n, n_anchored),
                                                device=device),
                       extra_on=z)
        return aux

    syncs = 0
    # the report's readings stay on the device: (before, after, mean
    # iterations) of each phase, read once after the last
    energies = (stageii_term_energies(prob, opts, prior, model_type)
                if return_report else None)
    reports = []

    def mean_energies(x, aux):
        return torch.stack([v.mean() for v in energies(x, aux).values()])

    shards = (_Shards(mesh, prob, opts, prior, model_type, system, device)
              if mesh is not None else None)

    def run(x, aux, pmask, e3, dl, use_velo=False, name=None):
        nonlocal syncs
        with span(spans.phase(name)):
            if use_velo:
                # on the global frames: the 2-frame halo crosses the shards
                with span(spans.VELO_AUX):
                    aux = dict(aux, **_velo_aux(x, P, opts.optimize_dynamics))
            if return_report:
                with span(spans.REPORT):
                    eb = mean_energies(x, aux)
            if shards is not None:
                xs, its = shards.solve(x, aux, pmask, e3, dl)
            else:
                r = batched_system_solve(system, x, aux, dl, param_mask=pmask,
                                         e_3=e3,
                                         compact_buckets=opts.compact_buckets,
                                         _graphs=graphs)
                xs, its = r.x, r.iterations
                syncs += r.host_syncs
            if return_report:
                with span(spans.REPORT):
                    reports.append((eb, mean_energies(xs, aux),
                                    its.to(torch.float64).mean()))
            if on_phase is not None:
                on_phase(name, xs.cpu().numpy(),
                         simulate_markers(prob, opts, xs).cpu().numpy())
            return xs, its

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
                        dl_opts, name=f"anneal{scale:g}")
        xa, _ = run(xa, aux_for(a), step2_mask, 1e-2, dl_opts,
                    name="anchor_step2")
        with span(spans.SLERP):
            seg = np.minimum(
                np.searchsorted(anchor_ids, np.arange(F), "right") - 1,
                len(anchor_ids) - 2)
            lo = anchor_ids[seg]
            hi = anchor_ids[seg + 1]
            alpha = torch.as_tensor(
                ((np.arange(F) - lo) / np.maximum(hi - lo, 1)).astype(
                    np.float32), device=device)
            x = _interp_x(xa, torch.as_tensor(seg, device=device),
                          torch.as_tensor(seg + 1, device=device), alpha,
                          model)
    else:
        x = rigid_init(prob, opts, obs, maskf)
        for scale in (10.0, 5.0, 1.0):
            x, _ = run(x, aux_for(None, scale), step1_mask, opts.e_3_anneal,
                       dl_opts, name=f"anneal{scale:g}")
        if return_report:
            reports.append(reports[-1])   # no anchor pass: keep the slots

    x, _ = run(x, aux_full, step1_mask, 1e-2, dl_opts, name="step1")
    x, _ = run(x, aux_full, step2_mask, 1e-2, dl_opts, name="step2")

    # ---- pass B: Jacobi smoothing sweeps ------------------------------------
    n_before = len(reports)
    for _ in range(opts.smoothing_sweeps):
        x, _ = run(x, aux_full, step2_mask, 1e-2, dl_opts, use_velo=True,
                   name="sweep")
    if return_report:
        # one "sweeps" slot: before the first sweep, after the last
        sweeps = reports[n_before:] or reports[-1:]
        reports[n_before:] = [(sweeps[0][0], sweeps[-1][1], sweeps[-1][2])]

    iters = torch.zeros((F,), dtype=torch.int32, device=device)
    if opts.e_3_polish is not None:
        use_velo = opts.smoothing_sweeps > 0 and F > 2
        x, iters = run(x, aux_full, step2_mask, opts.e_3_polish, dl_polish,
                       use_velo=use_velo, name="polish")
    elif return_report:
        reports.append(reports[-1])
    shard_syncs = ()
    if shards is not None:
        shard_syncs = tuple(shards.syncs)
        syncs = sum(shard_syncs)
    result = _finalize(prob, opts, x, iters, obs, maskf, syncs)
    if not return_report:
        return result
    with span(spans.REPORT):
        eb, ea, it = (torch.stack([r[i] for r in reports]).cpu().numpy()
                      for i in range(3))
    return result, StageIIReport(
        phase_names=STAGEII_PHASE_NAMES,
        term_names=report_term_names(prob, opts, prior, model_type),
        energies_before=eb, energies_after=ea, iterations=it,
        shard_syncs=shard_syncs)


def _replicate(obj, device):
    """`obj` with every tensor it holds on `device`: tensors, dataclasses,
    named and plain tuples, lists, dicts and Python closures (a callable
    prior such as `mahalanobis.horse_prior`'s) are rebuilt; other objects
    are returned as they are."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _replicate(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[_replicate(v, device) for v in obj])
    if isinstance(obj, (tuple, list)):
        return type(obj)(_replicate(v, device) for v in obj)
    if isinstance(obj, dict):
        return {k: _replicate(v, device) for k, v in obj.items()}
    if isinstance(obj, types.FunctionType) and obj.__closure__:
        cells = tuple(types.CellType(_replicate(c.cell_contents, device))
                      for c in obj.__closure__)
        return types.FunctionType(obj.__code__, obj.__globals__,
                                  obj.__name__, obj.__defaults__, cells)
    return obj


class _Shards:
    """A solve's phases on a mesh (the JAX package's `_shard_solve`): pad
    the batch to a multiple of the mesh's shards with all-missing frames
    (they converge at once and are sliced away), split x and aux into
    contiguous shards, solve this process's shards each on its device from
    a host thread of its own (on a stream of its own on CUDA, so that one
    shard's per-iteration read of its active count holds up no other), and
    gather x and the iterations back onto `device` (and, over processes,
    from every rank: `mesh.all_gather`).

    The problem, prior and system are replicated to each distinct device of
    the mesh once a solve. `syncs` holds each local shard's host syncs."""

    def __init__(self, mesh, prob, opts, prior, model_type, system, device):
        self.mesh, self.opts, self.device = mesh, opts, device
        self.systems = {prob.device: system}
        for dev in dict.fromkeys(mesh.devices):
            if dev not in self.systems:
                self.systems[dev] = make_stageii_system(
                    _replicate(prob, dev), opts, _replicate(prior, dev),
                    model_type)
        self.streams = [torch.cuda.Stream(device=dev) if dev.type == "cuda"
                        else None for dev in mesh.devices]
        self.syncs = [0] * len(mesh.devices)

    def _one(self, i, x, aux, pmask, e3, dl):
        dev, stream = self.mesh.devices[i], self.streams[i]
        with contextlib.ExitStack() as ctx:
            if stream is not None:
                ctx.enter_context(torch.cuda.device(dev))
                ctx.enter_context(torch.cuda.stream(stream))
            r = batched_system_solve(
                self.systems[dev], x.to(dev),
                {k: v.to(dev) for k, v in aux.items()}, dl,
                param_mask=pmask.to(dev), e_3=e3,
                compact_buckets=self.opts.compact_buckets)
            if stream is not None:
                stream.synchronize()
        return r

    def _local(self, x, aux):
        """x and aux padded to a multiple of the shards with zeros, and this
        process's shards of them: [(x_i, aux_i)], in frame order."""
        mesh = self.mesh
        n_local = len(mesh.devices)
        F = x.shape[0]
        pad = (-F) % mesh.num_shards
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
            aux = {k: torch.cat([v, v.new_zeros((pad,) + v.shape[1:])])
                   for k, v in aux.items()}
        Fs = x.shape[0] // mesh.num_shards
        lo = mesh.process_index * n_local * Fs
        return [(x[lo + i * Fs: lo + (i + 1) * Fs],
                 {k: v[lo + i * Fs: lo + (i + 1) * Fs]
                  for k, v in aux.items()}) for i in range(n_local)]

    def _gather(self, parts, F):
        """The local shards' tensors (each (Fs, ...)) on `device`, every
        process's concatenated in frame order, the pad dropped."""
        block = torch.cat([p.to(self.device) for p in parts])
        if self.mesh.num_processes > 1:
            block = self.mesh.all_gather(block)
        return block[:F]

    def assemble(self, x, aux):
        """(f, g, B (F, D, D)) of every frame, each shard assembled by its
        device's system in turn (one assembly a shard, no threads)."""
        outs = []
        for i, (xs, auxs) in enumerate(self._local(x, aux)):
            dev = self.mesh.devices[i]
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                outs.append(self.systems[dev].system_fn(
                    xs.to(dev), {k: v.to(dev) for k, v in auxs.items()}))
        F = x.shape[0]
        return tuple(self._gather([o[j] for o in outs], F) for j in range(3))

    def solve(self, x, aux, pmask, e3, dl):
        n_local = len(self.mesh.devices)
        F = x.shape[0]
        shards = self._local(x, aux)
        if self.device.type == "cuda":
            # the shards' streams read x and aux: let the problem's device
            # finish writing them first
            torch.cuda.synchronize(self.device)
        with ThreadPoolExecutor(n_local,
                                thread_name_prefix="stageii-shard") as pool:
            futs = [pool.submit(self._one, i, xs, auxs, pmask, e3, dl)
                    for i, (xs, auxs) in enumerate(shards)]
            rs = [f.result() for f in futs]
        for i, r in enumerate(rs):
            self.syncs[i] += r.host_syncs
        # x and the iterations (exact in float32) travel as one block
        block = self._gather([torch.cat([r.x, r.iterations[:, None]
                                         .to(x.dtype)], dim=1) for r in rs],
                             F)
        return block[:, :-1].contiguous(), block[:, -1].to(torch.int32)


def stageii_system_probe(prob: StageIIProblem,
                         opts: StageIIOptions,
                         markers_obs,
                         mask,
                         prior: Optional[Prior] = None,
                         model_type: Optional[str] = None,
                         mesh=None):
    """One batched Gauss-Newton system (f (F,), g (F, D), B (F, D, D)) at
    the rigid-init point (`moshpp_tpu/pipeline/stageii.py::
    stageii_system_probe`), on the problem's device: the data weights of
    the observed markers, anneal = 1 + (M - n_obs) / M x wt("annealing"),
    the anchor pass's prior scale 10, the velocity and extra anchors off.

    With `mesh` (a `parallel.FrameMesh`) the frames are laid out as a
    sharded solve lays them out (`_Shards`): x0 and the finished aux padded
    with zeros to a multiple of the shards, as the JAX package pads them
    (a pad frame has zero weights), each contiguous shard assembled on its
    device, gathered back (over processes with `mesh.all_gather`) and the
    pad dropped. The real frames' rows do not depend on the pad. Held
    against the unsharded probe it pins the frame decomposition to
    rounding, which a whole solve of a system of condition ~1e7 cannot.
    """
    _check_mesh(mesh)
    model_type = model_type or prob.sub_model.model_type
    system = make_stageii_system(prob, opts, prior, model_type)
    with fp32_matmul():
        x0, aux = probe_inputs(prob, opts, markers_obs, mask)
        if mesh is None:
            return system.system_fn(x0, aux)
        shards = _Shards(mesh, prob, opts, prior, model_type, system,
                         prob.device)
        return shards.assemble(x0, aux)


def probe_inputs(prob: StageIIProblem, opts: StageIIOptions, markers_obs,
                 mask):
    """`stageii_system_probe`'s point and aux: (x0 (F, D) the rigid init,
    aux of every frame) on the problem's device."""
    dev = prob.device
    obs = torch.as_tensor(markers_obs, dtype=torch.float32, device=dev)
    maskf = torch.as_tensor(mask, device=dev).to(torch.float32)
    F, M = maskf.shape
    P = prob.sub_model.pose_dof
    E = _num_extra(opts)
    wt = opts.wt
    n_obs = torch.sum(maskf, dim=1)
    zeros = lambda *shape: torch.zeros((F,) + shape, device=dev)
    aux = {"markers": obs, "mask": maskf,
           "wt_data": wt("data") * NUM_TRAIN_MARKERS
           / torch.clamp(n_obs, min=1.0),
           "anneal": 1.0 + (M - n_obs) / M * wt("annealing"),
           "wt_pose_scale": torch.full((F,), 10.0, device=dev),
           "velo_anchor": zeros(P), "velo_on": zeros(),
           "extra_anchor": zeros(E), "extra_on": zeros()}
    return rigid_init(prob, opts, obs, maskf), aux


@spanned(spans.FINALIZE)
def _finalize(prob, opts, x, iters, markers_obs, maskf, syncs) -> StageIIResult:
    model = prob.sub_model
    trans, pose, extra = split_x(x, model.pose_dof)
    sim = simulate_markers(prob, opts, x)
    err = torch.sqrt(torch.sum((sim - markers_obs) ** 2, -1)) * maskf
    data_err = torch.sum(err, -1) / torch.clamp(torch.sum(maskf, 1), min=1.0)
    return StageIIResult(trans=trans, pose=pose,
                         fullpose=fullpose_from_pose(model, pose),
                         extra=extra, markers_sim=sim,
                         data_err=data_err, iterations=iters,
                         host_syncs=syncs)
