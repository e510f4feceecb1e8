#!/usr/bin/env python
"""Drive the PyTorch port's stage-ii slice and stage i on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each failing loudly (exception, nonzero exit, no ok line):

  0. the card: refuse to run without CUDA; print the card, CUDA, nvcc and
     the TF32 flags (set off);
  1. build the Hopper kernels from moshpp_torch/csrc with nvcc (sm_90a),
     one nvcc per source in parallel;
  2. hold every E=0 kernel against its plain PyTorch version on the card at
     the main-path shapes (full-width SMPL+H, 46 markers, F=4096, D=117),
     and time both (kernels host-inclusive, as the plain versions, and
     device-only); the direction kernel also against the plain version in
     float64 on systems where 24 CG iterations have not converged;
  3. parity: solve the same problems on the CPU (plain versions) and on the
     card (kernels), polish through PCG in both: the reference's
     quality-parity problem at its own size and tolerances, and the bench
     problem at F=256, whose wander is held to the CPU's own floor;
  4. the slice: `mosh_stageii_solve` at the bench.py protocol (F=4096,
     maxiter=100, two smoothing sweeps, fingers free): one warm-up, the
     median of 3 timed solves, accuracy, host syncs, and each kernel's
     launch count from one solve;
  2b-4b. the same for the DMPL path: the bench protocol with 8 DMPL
     soft-tissue coefficients a frame (optimize_dynamics, shapedirs columns
     16-23, D=125): the four E-carrying kernels against their plain
     versions (datr included), the direction kernel at D=125 as in phase 2
     (recorded as dogleg_direction@D125), CPU-vs-card parity at F=256, and
     the F=4096 DMPL slice, which also reports the DMPL coefficients' RMS
     error;
  2c-4c. the same for the SMPL-X face path: the bench protocol on SMPL-X
     with the reference's 80 expressions (optimize_face, shapedirs columns
     300-379, the jaw free, D=206), which takes the tiled extras route: its
     six kernels against their plain versions (q, datr and the final jm
     included) with a PyTorch library call timed beside the two that have
     one (those two, and every fk_smalls instantiation of phases 2-2c,
     also at the solve's bucket sizes F = 2048, 512, 128, with their
     occupancy), the direction kernel at D=206
     (dogleg_direction@D206), parity at
     F=256, and the F=4096 face slice, which also reports the expressions'
     and the jaw's RMS errors;
  2d-4d. the folded-weights path (`StageIIOptions.fold_weights`) on the
     three problems: the folded marker rows `marker_rows<jac[,ext|,tiled],
     fold>` against their plain versions and against the unfolded kernels
     times w (bit for bit on the residual and the trans, pose and inline
     columns), timed beside the unfolded kernel plus its torch weighting
     pass (`unfolded_ms`); `pcg_direction` (the plain PCG entry point,
     which no solve calls) on each problem's real system and on synthetic
     ones, held to its float64 plain version; the card's folded solve at
     F=256 against the CPU's (phase 3's, 3b's, and a folded one for the
     face problem); the three folded slices at F=4096, with their peak
     device memory beside the unfolded slices';
  2e-4e, 2f-4f, 2g-4g. the other families (`FAMILIES`): the SMAL horse
     (`horse_problem`: J=36, P=108, D=111, its callable prior, Mahalanobis
     rows and leg-bend rows, loaded with `load_horse_prior`), the SMAL dog
     (`dog_problem`: J=35, P=105, D=108, an 8-component GMM on its 93
     gathered dofs, loaded with `load_dog_prior`), both at SMAL's 3889
     vertices with 46 markers, and a rigid prop (`object_problem`: read
     from a PLY, one joint, no posedirs, 10 markers, no prior, D=6): the
     five main-path kernels at each family's shapes against their plain
     versions (recorded as `<name>@horse`, `@dog`, `@object`), CPU-vs-card
     parity at F=64 with phase 3b's floor gate, and the F=4096 slice;
  5. a long sequence: the bench problem at F=40,000 solved on the card in
     one batch and in three chunks (chunk_frames 16384, chunk_halo 32)
     with a checkpoint directory, then again from the checkpoints: the
     chunked run's launches, its mean marker error against the one batch's,
     its deviation on the seam frames against a floor drawn from two
     one-batch solves 1e-7 m apart, and the rerun's (no solve, the same
     arrays bit for bit);
  6. stage i (no hand-written kernel lies on its path: J by jacfwd, the
     normal equations as float32 bmm, a Cholesky direction), on
     tools/bench_stagei.py's protocol built with the port's generators
     (full-width SMPL+H, 46 markers, 12 frames, the 4-step annealing at
     maxiter 100): 6a one undetailed and one detailed annealing step's
     residual, Jacobian, g and B on the card against the CPU; 6b a 4-frame
     solve on the CPU and on the card, held to the stage-i outcome bars or
     to the CPU's own floor under 1e-7 m of noise; 6c the slice (seconds a
     subject, the mean data error held to the JAX package's on the same
     problem, the recovery metrics, host syncs, iterations, peak memory);
     6d eight subjects in one batched solve against their single solves;
     6e 6c's betas and latent markers chained into stage ii at F=4096 of
     the same subject, every E=0 kernel launched.

Every kernel entry carries its bound: the least time the card could take
for the call, the larger of its bytes (each input read once, each output
written once) over the memory rate and its operations over the float32
and float64 rates (`bound`).

The last three lines of stdout are the kernels JSON (34 kernel entries:
one per Pallas kernel, and the five main-path kernels again at each other
family's shapes), the card's name and power limit, and {"ok": true,
"device": {...}}. A fuller record goes to chiprun_out/chip_smoke.json.
"""

import dataclasses
import json
import multiprocessing
import os
import pickle
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FRAMES = 4096
PARITY_FRAMES = 256
MARKERS = 46
TIMED_SOLVES = 3

# tolerances of the per-kernel comparisons (phase 2): smalls and sim in
# absolute units (m, or unitless for rotations), jm scaled by max(|jm|, 1),
# as tests/test_pallas_jac.py holds the TPU kernels; the direction as
# tests/test_solver.py holds the TPU direction kernel
TOL_SMALLS = 2e-5
TOL_SIM = 2e-5
TOL_JM = 3e-4
TOL_DIR_RTOL, TOL_DIR_ATOL, TOL_PRED_RTOL = 2e-4, 1e-5, 2e-3
# the direction kernel against the plain version in float64: at most this
# multiple of the float32 plain version's own distance from float64, the
# largest over the unknowns' given order and PERM_SEEDS permutations of them
# (unconverged CG is chaotic in the summation order: at D=206, cond ~1e3,
# 24 iterations, pred's distance moves 0.39-3.6 across orders; PERF.md)
TOL_DIR_VS_F64 = 4.0
PERM_SEEDS = (1, 2)
# parity (phase 3), the reference's quality-parity bar and settings
PARITY_MEAN_MM, PARITY_WANDER_MM = 0.02, 0.6
FLOOR_FACTOR = 1.5     # bench-problem wander limit: times the CPU's floor
# the floor is the largest of these perturbed CPU solves' wanders: one
# sample is a noisy estimate (DMPL problem at F=256, seeds 7-10: 0.70, 0.90,
# 1.44, 1.50 mm; bench problem: 1.70, 1.09, 1.14, 1.12 mm; PERF.md)
FLOOR_SEEDS = (7, 8, 9)
# the floor's CPU solves run side by side with the unperturbed one, each in
# a process of its own (spawned) on this many threads
CPU_THREADS_PER_SOLVE = 2
PARITY_OPTS = dict(polish_solver="pcg", e_3_polish=1e-8, e_3_anneal=1e-4,
                   cg_iters=48, cg_iters_polish=256, maxiter=300)
MAX_MEAN_ERR_MM = 1.0
HOLD_CYCLES = 100_000_000   # ~50 ms of GPU sleep ahead of timed kernel runs
# the H100 SXM's peaks at 700 W (NVIDIA's data sheet): HBM3, and float32 and
# float64 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_PER_S = 67e12
FP64_PER_S = 34e12

# kernels of the E=0 path and of the DMPL path: (source, TPU kernel)
TPU_KERNELS = {
    "fk_smalls<jac>": ("moshpp_torch/csrc/fk_smalls.cu",
                       "moshpp_tpu/ops/pallas_marker_jac.py:374"),
    "fk_smalls<sim>": ("moshpp_torch/csrc/fk_smalls.cu",
                       "moshpp_tpu/ops/pallas_marker_jac.py:806"),
    "marker_rows<jac>": ("moshpp_torch/csrc/marker_rows.cu",
                         "moshpp_tpu/ops/pallas_marker_jac.py:699"),
    "marker_rows<sim>": ("moshpp_torch/csrc/marker_rows.cu",
                         "moshpp_tpu/ops/pallas_marker_jac.py:898"),
    "dogleg_direction": ("moshpp_torch/csrc/dogleg_direction.cu",
                         "moshpp_tpu/solver/pallas_pcg.py:125"),
}
EXT_KERNELS = {
    "fk_smalls<jac,ext>": ("moshpp_torch/csrc/fk_smalls.cu",
                           "moshpp_tpu/ops/pallas_marker_jac.py:384"),
    "fk_smalls<sim,ext>": ("moshpp_torch/csrc/fk_smalls.cu",
                           "moshpp_tpu/ops/pallas_marker_jac.py:816"),
    "marker_rows<jac,ext>": ("moshpp_torch/csrc/marker_rows.cu",
                             "moshpp_tpu/ops/pallas_marker_jac.py:712"),
    "marker_rows<sim,ext>": ("moshpp_torch/csrc/marker_rows.cu",
                             "moshpp_tpu/ops/pallas_marker_jac.py:908"),
}
TILED_KERNELS = {
    "fk_smalls<jac,tiled>": ("moshpp_torch/csrc/fk_smalls.cu",
                             "moshpp_tpu/ops/pallas_marker_jac.py:394"),
    "fk_smalls<sim,tiled>": ("moshpp_torch/csrc/fk_smalls.cu",
                             "moshpp_tpu/ops/pallas_marker_jac.py:826"),
    "extras_tangent": ("moshpp_torch/csrc/extras_tangent.cu",
                       "moshpp_tpu/ops/pallas_marker_jac.py:411"),
    "marker_rows<jac,tiled>": ("moshpp_torch/csrc/marker_rows.cu",
                               "moshpp_tpu/ops/pallas_marker_jac.py:726"),
    "marker_rows<sim,tiled>": ("moshpp_torch/csrc/marker_rows.cu",
                               "moshpp_tpu/ops/pallas_marker_jac.py:918"),
    "extras_cols": ("moshpp_torch/csrc/extras_cols.cu",
                    "moshpp_tpu/ops/pallas_marker_jac.py:445"),
}
FOLD_KERNELS = {
    "marker_rows<jac,fold>": ("moshpp_torch/csrc/marker_rows.cu",
                              "moshpp_tpu/ops/pallas_marker_jac.py:1109"),
    "marker_rows<jac,ext,fold>": ("moshpp_torch/csrc/marker_rows.cu",
                                  "moshpp_tpu/ops/pallas_marker_jac.py:1122"),
    "marker_rows<jac,tiled,fold>": ("moshpp_torch/csrc/marker_rows.cu",
                                    "moshpp_tpu/ops/pallas_marker_jac.py:740"),
}
PCG_KERNEL = {
    "pcg_direction": ("moshpp_torch/csrc/dogleg_direction.cu",
                      "moshpp_tpu/solver/pallas_pcg.py:66"),
}
# the template flags of each kernel's mangled name, for the ptxas report
TEMPLATE_FLAGS = {"fk_smalls": ("jac", "ext", "tiled"),
                  "marker_rows": ("jac", "ext", "tiled", "fold"),
                  "dogleg_direction": ("pcg", "tri")}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, n=5, hold=False):
    """Mean time of `fn` over n runs after one warm-up (CUDA events). Without
    `hold` the events also see the host's time to queue the runs, as the
    plain versions' readings do. With `hold`, a GPU sleep holds the
    stream while the host queues the n runs, so the events see device time
    alone (a 30 us kernel reads 35-63 us without it; PERF.md). Only for
    functions that never wait on the device: the kernels' wrappers, not the
    plain versions, which copy small tables to the card synchronously."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def timed(kernel_fn, plain_fn, n_plain=5) -> dict:
    """A kernel's times beside its plain version's: `ms` and `plain_ms`
    measured alike (host-inclusive), `ms_device` with the stream held."""
    return dict(ms=cuda_ms(kernel_fn), ms_device=cuda_ms(kernel_fn, hold=True),
                plain_ms=cuda_ms(plain_fn, n=n_plain))


def max_err(a, b) -> float:
    """The largest |a - b|; 0 for empty tensors (the rigid object's one
    joint has no pose features)."""
    return float((a - b).abs().max()) if a.numel() else 0.0


def smalls_errors(name, k, p) -> dict:
    """Max abs error of each field of an fk_smalls kernel's output `k`
    against its plain version's `p`, asserted within TOL_SMALLS times the
    largest plain value (at least 1)."""
    import torch
    torch.cuda.synchronize()
    errs = {f: max_err(a, b) for f, a, b in zip(k._fields, k, p)
            if a is not None}
    scale = max(1.0, max(float(b.abs().max()) for b in p
                         if b is not None and b.numel()))
    log(f"  {name}: max abs err {errs} (scale {scale:.3g})")
    assert max(errs.values()) <= TOL_SMALLS * scale, (name, errs)
    return errs


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(read, written, flops32, flops64=0.0) -> dict:
    """The least time the card could take for a call: the larger of its
    bytes (the tensors `read` once, `written` once) over HBM_BYTES_PER_S
    and its operations over the float32 and float64 rates."""
    b = nbytes(*read) + nbytes(*written)
    t_bytes = b / HBM_BYTES_PER_S
    t_ops = flops32 / FP32_PER_S + flops64 / FP64_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=b, flops32=float(flops32), flops64=float(flops64))


def chain_lengths(tables) -> np.ndarray:
    """(J,) joints on each joint's root path, itself included."""
    return tables.anc.sum(1).cpu().numpy()


def fk_flops(tables, F, with_jac, route):
    """float32 operations of one fk_smalls call, counted from its loops
    (an FMA is two): ~90 a (frame, joint) for Rodrigues, A_tr and the
    features, 72 for each product of its root path (each joint composes its
    own), ~700 more for dR and the generators; inline extras 12 E more, and
    with the Jacobian their chain sums."""
    J, E = tables.num_joints, tables.n_extra
    per = 90 + (700 if with_jac else 0)
    total = F * (J * per + 72 * float(np.sum(chain_lengths(tables) - 1)))
    if route == "ext":
        total += F * J * 12 * E
        if with_jac:
            total += F * E * float(np.sum(18 + 18 * chain_lengths(tables)))
    elif route == "tiled":
        total += F * J * 6
    return total


def rows_flops(tables, F, with_jac, route):
    """(float32, float64) operations of one marker_rows call, counted from
    its loops: per (frame, marker) the float64 pose blend, weighted
    transforms and local frame; with the Jacobian the z, ancestor-sum,
    column, hand-PCA and extras phases in float32."""
    M, J, E = tables.num_markers, tables.num_joints, tables.n_extra
    featN, hand = tables.feat_n, tables.hand_dof
    f64 = 2 * 9 * featN + 2 * 36 * J + 72 + (900 if with_jac else 300)
    if route == "ext":
        f64 += 2 * 9 * E
    f32 = 0.0
    if with_jac:
        w3 = tables.w3.cpu().numpy()                         # (M, 3, J)
        anc_pairs = float(np.sum((w3 != 0) * chain_lengths(tables)))
        nhand = 3 * J - tables.body_dof
        f32 = (M * 63 * J + 6 * anc_pairs
               + M * 3 * J * 3 * (114 if featN else 24)
               + M * 3 * hand * nhand * 2)
        if route == "ext":
            f32 += M * (9 * E * (2 * J + 6) + 3 * E * 18)
        elif route == "tiled":
            f32 += M * 27 * 6
    return F * f32, F * M * f64


def synthetic_problem(frames, device, opts, *, num_verts, dof_per_hand,
                      model_seed, prior_components, prior_seed, beta_scale,
                      pose0_scale, num_shape_dirs=None, model_type="smplh"):
    """A synthetic SMPL+H (or `model_type`) stage-ii problem with 46
    markers, smooth random motion and a GMM prior on the 63 body dofs; numpy
    draws in the order of bench.py and __graft_entry__._tiny_problem. With
    extra dims the truth also carries them, drawn after the rest from the
    same rng: DMPLs (`opts.optimize_dynamics`) with amplitude a = 0.3,
    expressions (`opts.optimize_face`) with a = 0.1, x[0] ~ N(0, a^2),
    x[t] = 0.97 x[t-1] + N(0, (a/10)^2); the observations then come from
    per-frame shape coefficients (`stageii._betas_for_lbs`). SMPL-X's eye
    dofs (pose 69:75) stay zero: the reference never frees them."""
    import torch
    from moshpp_torch.models import make_synthetic_model
    from moshpp_torch.ops.surface import vertex_normals
    from moshpp_torch.pipeline.stageii import (_num_extra,
                                               prepare_stageii_problem,
                                               simulate_markers)
    from moshpp_torch.priors.gmm import make_gmm_prior

    rng = np.random.default_rng(0)
    model = make_synthetic_model(model_type, num_verts=num_verts,
                                 seed=model_seed, dof_per_hand=dof_per_hand,
                                 num_shape_dirs=num_shape_dirs, device=device)
    prior = make_gmm_prior(dim=63, num_components=prior_components,
                           seed=prior_seed, scale=0.3, device=device)
    V = model.v_template.shape[0]
    vids = rng.choice(V, MARKERS, replace=False)
    betas = (rng.normal(size=16) * beta_scale).astype(np.float32)
    bt = torch.as_tensor(betas, device=device)
    can_v = model.v_template + torch.einsum("vcb,b->vc",
                                            model.shapedirs[..., :16], bt)
    vn = vertex_normals(can_v, model.faces)
    latents = (can_v[vids] + vn[vids] * 0.0095).cpu().numpy()
    P = model.pose_dof
    poses = np.zeros((frames, P), np.float32)
    poses[0] = rng.normal(size=P) * pose0_scale
    for t in range(1, frames):
        poses[t] = 0.97 * poses[t - 1] + rng.normal(size=P).astype(np.float32) * 0.02
    trans = np.cumsum(rng.normal(size=(frames, 3)) * 0.005, 0).astype(np.float32)
    if model_type == "smplx":
        poses[:, 69:75] = 0.0
    extra = np.zeros((frames, _num_extra(opts)), np.float32)
    if extra.shape[1]:
        a = 0.3 if opts.optimize_dynamics else 0.1
        extra[0] = rng.normal(size=extra.shape[1]) * a
        for t in range(1, frames):
            extra[t] = (0.97 * extra[t - 1]
                        + rng.normal(size=extra.shape[1]) * a / 10)
    prob = prepare_stageii_problem(model, betas, latents, opts, device=device)
    x_true = torch.as_tensor(np.concatenate([trans, poses, extra], 1),
                             device=device)
    obs = simulate_markers(prob, opts, x_true)
    mask = torch.ones((frames, MARKERS), dtype=torch.bool, device=device)
    return dict(model=model, prior=prior, betas=bt, opts=opts, prob=prob,
                x_true=x_true, obs=obs, mask=mask, model_type=model_type)


def bench_problem(frames, device):
    """The bench.py problem: num_verts=6890 rounds up to the 10242-vertex
    icosphere, dof_per_hand=24 (D=117), an 8-component prior; maxiter 100,
    two smoothing sweeps, fingers free."""
    from moshpp_torch.pipeline.stageii import StageIIOptions
    return synthetic_problem(
        frames, device, StageIIOptions(maxiter=100, smoothing_sweeps=2,
                                       optimize_fingers=True),
        num_verts=6890, dof_per_hand=24, model_seed=3, prior_components=8,
        prior_seed=1, beta_scale=0.4, pose0_scale=0.15)


def dmpl_problem(frames, device):
    """The bench problem with 8 DMPL coefficients a frame: 24 shape dirs
    (16 betas, DMPLs in columns 16-23; the model's random draws differ from
    the bench model's), optimize_dynamics, D = 3 + 114 + 8 = 125."""
    from moshpp_torch.pipeline.stageii import StageIIOptions
    return synthetic_problem(
        frames, device, StageIIOptions(maxiter=100, smoothing_sweeps=2,
                                       optimize_fingers=True,
                                       optimize_dynamics=True, num_dmpls=8),
        num_verts=6890, dof_per_hand=24, model_seed=3, prior_components=8,
        prior_seed=1, beta_scale=0.4, pose0_scale=0.15, num_shape_dirs=24)


def face_problem(frames, device):
    """The bench problem on SMPL-X with the reference's production face
    configuration (moshpp_conf.yaml: num_expressions 80,
    betas_expr_start_id 300): 400 shape dirs, expressions in columns
    300-379, the jaw free, J=55, P = 75 + 2 x 24 = 123, D = 206. num_verts
    6890 rounds up to the bench model's 10242-vertex icosphere (SMPL-X has
    10475)."""
    from moshpp_torch.pipeline.stageii import StageIIOptions
    return synthetic_problem(
        frames, device, StageIIOptions(maxiter=100, smoothing_sweeps=2,
                                       optimize_fingers=True,
                                       optimize_face=True,
                                       num_expressions=80, expr_start=300),
        num_verts=6890, dof_per_hand=24, model_seed=3, prior_components=8,
        prior_seed=1, beta_scale=0.4, pose0_scale=0.15, num_shape_dirs=400,
        model_type="smplx")


def parity_problem(frames, device):
    """The reference's quality-parity problem (__graft_entry__.py
    dryrun_multichip: _tiny_problem(num_verts=600, markers=46,
    smooth_motion=True), at its tight tolerances)."""
    from moshpp_torch.pipeline.stageii import StageIIOptions
    return synthetic_problem(
        frames, device, StageIIOptions(smoothing_sweeps=1, **PARITY_OPTS),
        num_verts=600, dof_per_hand=6, model_seed=5, prior_components=3,
        prior_seed=2, beta_scale=0.3, pose0_scale=0.12)


# SMAL's template mesh (Zuffi et al., CVPR 2017) has 3889 vertices; the
# icosphere rounds it up to 10242, as it rounds up SMPL+H's 6890
SMAL_VERTS = 3889
OBJECT_MARKERS = 10
OBJECT_SIZE_M = (0.11, 0.07, 0.19)   # the prop of tests/golden_common.py
KEY_STRIDE = 32     # frames between the animals' prior-drawn key poses
# the animal priors' spread (rad): with the truth drawn from the prior, the
# optimum of prior and data sits 0.8 mm of mean marker error off the truth
# at 46 markers, and wider priors (larger poses) move it further (0.3:
# 1.16 mm on the horse, a CPU solve at F=64)
ANIMAL_PRIOR_SCALE = 0.15


def smooth_keys(keys, frames):
    """(frames, D) through key poses (K, D) set every KEY_STRIDE frames,
    cubic smoothstep between neighbours (at rest at each key)."""
    t = np.arange(frames) / KEY_STRIDE
    i = np.minimum(t.astype(int), len(keys) - 2)
    a = (t - i)[:, None]
    s = a * a * (3.0 - 2.0 * a)
    return ((1.0 - s) * keys[i] + s * keys[i + 1]).astype(np.float32)


def _covariances(rng, dim, K, scale):
    """K covariances scale^2 (I + A A^T), A ~ N(0, 0.1^2), as the JAX
    package's synthetic GMM prior draws them."""
    out = []
    for _ in range(K):
        a = rng.normal(size=(dim, dim)) * 0.1
        out.append(scale ** 2 * (np.eye(dim) + a @ a.T))
    return np.stack(out)


def _problem_dict(model, prior, opts, betas, latents, poses, trans, device,
                  model_type, **extra):
    """Observations of the truth (trans, poses) through the port's forward
    model, and the problem around them."""
    import torch
    from moshpp_torch.pipeline.stageii import (prepare_stageii_problem,
                                               simulate_markers)
    prob = prepare_stageii_problem(model, betas, latents, opts, device=device)
    x_true = torch.as_tensor(np.concatenate([trans, poses], 1), device=device)
    obs = simulate_markers(prob, opts, x_true)
    mask = torch.ones(obs.shape[:2], dtype=torch.bool, device=device)
    return dict(model=model, prior=prior, betas=torch.as_tensor(
        betas, device=device), opts=opts, prob=prob, x_true=x_true, obs=obs,
        mask=mask, model_type=model_type, **extra)


def _markers_on(model, betas, rng, M, device):
    """M latent markers 9.5 mm off random surface vertices of the shaped
    body."""
    import torch
    from moshpp_torch.ops.surface import vertex_normals
    vids = rng.choice(model.v_template.shape[0], M, replace=False)
    nb = len(betas)
    can_v = model.v_template + torch.einsum(
        "vcb,b->vc", model.shapedirs[..., :nb],
        torch.as_tensor(betas, device=device))
    vn = vertex_normals(can_v, model.faces)
    return (can_v[vids] + vn[vids] * 0.0095).cpu().numpy()


def _root_walk(rng, frames, scale0, step):
    """An AR(1) walk x_t = 0.97 x_(t-1) + N(0, step^2) of 3 dofs."""
    x = np.zeros((frames, 3), np.float32)
    x[0] = rng.normal(size=3) * scale0
    for t in range(1, frames):
        x[t] = 0.97 * x[t - 1] + rng.normal(size=3) * step
    return x


def animal_problem(family, frames, device):
    """A synthetic SMAL animal at the family's real joint tree and pose
    width (`animal_horse` J=36, P=108; `animal_dog` J=35, P=105), SMAL's
    vertex count, 46 markers (the bench protocol's), maxiter 100, two
    smoothing sweeps. The prior is written to a pkl in a temporary
    directory and loaded as a user would: the horse's Mahalanobis prior
    (`load_horse_prior`: keys `pic`, `mean_pose`, the first 81 dofs) and its
    leg-bend rows (`horse_prior`), or the dog's 8-component GMM over its 93
    `DOG_POSE_IDS` (`save_gmm_prior_pkl` with the dog's keys,
    `load_dog_prior`). The truth's prior-covered dofs pass through key poses
    drawn from the prior's own distribution every KEY_STRIDE frames
    (`sample_gmm_prior` for the dog; for the horse the Gaussian whose
    whitened rows (x - mean) @ prec are N(0, I)); the root is an AR(1) walk
    and the dofs the solve never frees (the horse's tail, mouth and ears,
    84-107; the dog's joints 2, 6, 29) stay at zero."""
    import tempfile
    from moshpp_torch.models import make_synthetic_model
    from moshpp_torch.models.body_model import pose_part_ids
    from moshpp_torch.pipeline.stageii import StageIIOptions
    from moshpp_torch.priors import gmm, mahalanobis

    rng = np.random.default_rng(0)
    model = make_synthetic_model(family, num_verts=SMAL_VERTS, seed=3,
                                 device=device)
    opts = StageIIOptions(maxiter=100, smoothing_sweeps=2)
    P = model.pose_dof
    body = np.asarray(pose_part_ids(family, optimize_toes=True)["body"])
    nkeys = frames // KEY_STRIDE + 2
    extra = {}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "prior.pkl")
        if family == "animal_horse":
            cov = _covariances(rng, P, 1, ANIMAL_PRIOR_SCALE)[0]
            mean = rng.normal(size=P) * ANIMAL_PRIOR_SCALE * 0.5
            with open(path, "wb") as f:
                pickle.dump({"pic": np.linalg.cholesky(np.linalg.inv(cov)),
                             "mean_pose": mean}, f)
            src = mahalanobis.load_horse_prior(path, device=device)
            prior = mahalanobis.horse_prior(src)
            # the Gaussian whose negative log-density is the rows' |r|^2,
            # as the GMM's rows are (sample_gmm_prior): r ~ N(0, I / 2)
            prec = src.prec.double().cpu().numpy()
            z = rng.standard_normal((nkeys, prec.shape[0])) / np.sqrt(2.0)
            keys = src.mean.double().cpu().numpy() + np.linalg.solve(
                prec.T, z.T).T
            extra["horse"] = src
        else:
            K, dim = 8, len(body)
            gmm.save_gmm_prior_pkl({
                "gmm_means": rng.normal(size=(K, dim)) * (
                    ANIMAL_PRIOR_SCALE * 0.5),
                "gmm_covs": _covariances(rng, dim, K, ANIMAL_PRIOR_SCALE),
                "gmm_weights": rng.dirichlet(np.ones(K))}, path)
            prior = mahalanobis.load_dog_prior(path, device=device)
            keys = gmm.sample_gmm_prior(prior, rng, nkeys)
    betas = (rng.normal(size=16) * 0.4).astype(np.float32)
    latents = _markers_on(model, betas, rng, MARKERS, device)
    poses = np.zeros((frames, P), np.float32)
    poses[:, :3] = _root_walk(rng, frames, 0.15, 0.02)
    poses[:, body] = smooth_keys(keys, frames)
    trans = np.cumsum(rng.normal(size=(frames, 3)) * 0.005, 0).astype(
        np.float32)
    return _problem_dict(model, prior, opts, betas, latents, poses, trans,
                         device, family, **extra)


def horse_problem(frames, device):
    return animal_problem("animal_horse", frames, device)


def dog_problem(frames, device):
    return animal_problem("animal_dog", frames, device)


def object_problem(frames, device):
    """A rigid prop: tests/golden_common.py's icosphere scaled to 0.11 x
    0.07 x 0.19 m, written as a PLY in a temporary directory and read back
    with `load_rigid_object`, as a one-joint model
    (`object_as_surface_model`); 10 markers, no prior, D=6; the rotation an
    AR(1) walk, the translation a random walk."""
    import tempfile
    from moshpp_torch.io.ply import write_ply
    from moshpp_torch.models.object_model import (load_rigid_object,
                                                  object_as_surface_model)
    from moshpp_torch.models.synthetic import icosphere
    from moshpp_torch.pipeline.stageii import StageIIOptions

    rng = np.random.default_rng(0)
    sv, sf = icosphere(2)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "prop.ply")
        write_ply(path, sv * np.asarray(OBJECT_SIZE_M), sf)
        model = object_as_surface_model(load_rigid_object(path, device=device))
    betas = np.zeros(model.num_betas, np.float32)
    latents = _markers_on(model, betas, rng, OBJECT_MARKERS, device)
    poses = _root_walk(rng, frames, 0.5, 0.05)
    trans = np.cumsum(rng.normal(size=(frames, 3)) * 0.005, 0).astype(
        np.float32)
    return _problem_dict(model, None, StageIIOptions(maxiter=100,
                                                     smoothing_sweeps=2),
                         betas, latents, poses, trans, device, "object")


def prior_on(bp, device):
    """The problem's prior on `device`: the GMM's tensors moved, the horse's
    callable rebuilt on its moved Mahalanobis prior, or None."""
    from moshpp_torch.priors import mahalanobis
    prior = bp["prior"]
    if prior is None:
        return None
    if "horse" in bp:
        src = bp["horse"]
        return mahalanobis.horse_prior(dataclasses.replace(
            src, mean=src.mean.to(device), prec=src.prec.to(device)))
    return dataclasses.replace(prior, **{
        f.name: getattr(prior, f.name).to(device)
        for f in dataclasses.fields(prior)})


def check_marker_kernels(bp, records, phase, suffix=""):
    """The fk_smalls and marker_rows variants of the problem's path (E=0 or
    E-carrying) against their plain versions at its shapes, and their
    times; recorded under their names with `suffix` (e.g. "@horse")."""
    import torch
    from moshpp_torch.ops import marker_jac as mj

    model, tables = bp["prob"].sub_model, bp["prob"].tables
    theta, trans, extra = mj.kernel_inputs(model, tables, bp["x_true"])
    route = tables.route
    F = theta.shape[0]
    log(f"phase {phase}: theta {tuple(theta.shape)}, M={tables.num_markers}, "
        f"E={tables.n_extra}, D={tables.dof}, featN={tables.feat_n}")
    t_fk = (tables.ancmask, tables.jnts, tables.trel)
    t_ext = (extra, tables.djnt, tables.dtrel) if extra is not None else ()

    sms = {}
    for with_jac in (True, False):
        name = mj._names(with_jac, route)[0] + suffix
        k = mj.fk_smalls(theta, tables, with_jac, extra)
        p = mj.fk_smalls_plain(theta, tables, with_jac, extra)
        errs = smalls_errors(name, k, p)
        records[name] = dict(
            max_abs_err=max(errs.values()),
            **timed(lambda: mj.fk_smalls(theta, tables, with_jac, extra),
                    lambda: mj.fk_smalls_plain(theta, tables, with_jac,
                                               extra)),
            **bound((theta, *t_fk, *t_ext), k,
                    fk_flops(tables, F, with_jac, route)),
            **fk_buckets(tables, route, with_jac, lambda n: mj.fk_smalls(
                theta[:n], tables, with_jac,
                None if extra is None else extra[:n])))
        log_buckets(name, records[name])
        if "datr" in errs:
            records[name]["datr_max_abs_err"] = errs["datr"]
        sms[with_jac] = k

    for with_jac in (True, False):
        name, sm = mj._names(with_jac, route)[1] + suffix, sms[with_jac]
        sim_k, jm_k = mj.marker_rows(sm, trans, tables, with_jac, extra)
        sim_p, jm_p = mj.marker_rows_plain(sm, trans, tables, with_jac, extra)
        torch.cuda.synchronize()
        e_sim = max_err(sim_k, sim_p)
        e = e_sim
        assert torch.isfinite(sim_k).all(), name
        assert e_sim <= TOL_SIM, (name, "sim", e_sim)
        if with_jac:
            e_jm = max_err(jm_k, jm_p)
            scale = max(float(jm_p.abs().max()), 1.0)
            log(f"  {name}: sim err {e_sim:.3g} m, jm err {e_jm:.3g} "
                f"(scale {scale:.3g}), jm {tuple(jm_k.shape)}")
            assert torch.isfinite(jm_k).all(), name
            assert e_jm <= TOL_JM * scale, (name, "jm", e_jm)
            e = max(e, e_jm)
            del jm_p
        else:
            log(f"  {name}: sim err {e_sim:.3g} m")
        f32, f64 = rows_flops(tables, F, with_jac, route)
        read = (*sm[:6], sm.datr, trans, *rows_tables(tables, with_jac),
                extra, tables.dv if extra is not None else None)
        records[name] = dict(
            max_abs_err=e,
            **timed(lambda: mj.marker_rows(sm, trans, tables, with_jac, extra),
                    lambda: mj.marker_rows_plain(sm, trans, tables, with_jac,
                                                 extra), n_plain=2),
            **bound(read, (sim_k, jm_k), f32, f64))
        torch.cuda.empty_cache()


# the frame counts the solve's compaction buckets launch at (F/2, F/8, F/32)
BUCKETS = (2048, 512, 128)


def bucket_ms(fn) -> dict:
    """Device ms of fn(n), a kernel on the first n frames, at each of
    BUCKETS."""
    return {n: cuda_ms(lambda: fn(n), hold=True) for n in BUCKETS}


def log_buckets(name, r):
    occ = (f"; {r['blocks_per_sm']} blocks an SM, {r['smem_bytes']} B shared "
           f"memory a block")
    if "warps" in r:
        occ += f", {r['warps']} warps"
    if "threads" in r:
        occ += (f", {r['threads']} threads, {r['frames_per_block']} frames ("
                + ", ".join(f"{o['frames_per_block']} at F={n}"
                            for n, o in r["bucket_occupancy"].items()) + ")")
    log(f"  {name}: device ms {r['ms_device']:.4f} at F={FRAMES}, "
        + ", ".join(f"{v:.4f} at F={n}" for n, v in
                    r["bucket_ms_device"].items()) + occ)


def fk_occupancy(tables, route, with_jac, F) -> dict:
    """Frames, threads and shared memory a block and blocks an SM of the
    fk_smalls launch at F frames, from its occupancy export."""
    import ctypes
    import torch
    from moshpp_torch import kernels
    from moshpp_torch.ops import marker_jac as mj
    lib, _ = kernels.library()
    nf = mj.fk_frames_per_block(F, kernels.sm_count(torch.device("cuda", 0)),
                                with_jac, route)
    smem, threads = ctypes.c_int(), ctypes.c_int()
    blocks = lib.fk_smalls_occupancy(
        int(with_jac), {"": 0, "ext": 1, "tiled": 2}[route],
        tables.num_joints, tables.n_extra if route == "ext" else 0, nf,
        ctypes.byref(smem), ctypes.byref(threads))
    return dict(frames_per_block=nf, threads=threads.value,
                smem_bytes=smem.value, blocks_per_sm=blocks)


def fk_buckets(tables, route, with_jac, fn) -> dict:
    """An fk_smalls launch's occupancy at F=FRAMES, and its device ms
    (fn(n) on the first n frames) and occupancy at each of BUCKETS."""
    return dict(**fk_occupancy(tables, route, with_jac, FRAMES),
                bucket_ms_device=bucket_ms(fn),
                bucket_occupancy={n: fk_occupancy(tables, route, with_jac, n)
                                  for n in BUCKETS})


def extras_occupancy(tables, F, cols=False) -> dict:
    """Blocks an SM, shared memory (and warps) a block of the extras_cols
    or (at F frames) extras_tangent launch, from its occupancy export."""
    import ctypes
    from moshpp_torch import kernels
    lib, _ = kernels.library()
    smem, warps = ctypes.c_int(), ctypes.c_int()
    J, E = tables.num_joints, tables.n_extra
    if cols:
        blocks = lib.extras_cols_occupancy(tables.num_markers, J, E,
                                           tables.wnz_j.shape[-1],
                                           ctypes.byref(smem))
        return dict(blocks_per_sm=blocks, smem_bytes=smem.value)
    blocks = lib.extras_tangent_occupancy(F, J, E, ctypes.byref(smem),
                                          ctypes.byref(warps))
    return dict(blocks_per_sm=blocks, smem_bytes=smem.value,
                warps=warps.value)


def rows_tables(tables, with_jac):
    """The problem tables a marker_rows call reads."""
    t = [tables.w3, tables.vsh3, tables.pd3, tables.cf]
    if with_jac:
        t += [tables.s3, tables.ancmask, tables.hc]
    return t


def check_tiled_kernels(bp, records, phase):
    """The six kernels of the tiled extras route against their plain
    versions at the problem's shapes, each fed the kernel route's own
    inputs: q, datr and uv compared too, and the final jm of the whole
    kernel route against the whole plain route. Times, bounds, and for
    extras_tangent and extras_cols one PyTorch library call each
    (`library_ms`)."""
    import torch
    from moshpp_torch.ops import marker_jac as mj

    model, tables = bp["prob"].sub_model, bp["prob"].tables
    assert tables.route == "tiled", tables.route
    theta, trans, extra = mj.kernel_inputs(model, tables, bp["x_true"])
    jshift, vpshift = mj.extra_shifts(tables, extra)
    F, M, J, E, D = (theta.shape[0], tables.num_markers, tables.num_joints,
                     tables.n_extra, tables.dof)
    Dp = D - E
    log(f"phase {phase}: theta {tuple(theta.shape)}, M={M}, E={E}, D={D}, "
        f"featN={tables.feat_n}; jshift {tuple(jshift.shape)}, vpshift "
        f"{tuple(vpshift.shape)}")
    t_fk = (tables.ancmask, tables.jnts, tables.trel)

    sms = {}
    for with_jac in (True, False):
        name = mj._names(with_jac, "tiled")[0]
        k = mj.fk_smalls_tiled(theta, jshift, tables, with_jac)
        p = mj.fk_smalls_tiled_plain(theta, jshift, tables, with_jac)
        errs = smalls_errors(name, k, p)
        records[name] = dict(
            max_abs_err=max(errs.values()),
            **timed(lambda: mj.fk_smalls_tiled(theta, jshift, tables, with_jac),
                    lambda: mj.fk_smalls_tiled_plain(theta, jshift, tables,
                                                     with_jac)),
            **bound((theta, jshift, *t_fk), k,
                    fk_flops(tables, F, with_jac, "tiled")),
            **fk_buckets(tables, "tiled", with_jac, lambda n: mj.fk_smalls_tiled(
                theta[:n], jshift[:n], tables, with_jac)))
        log_buckets(name, records[name])
        if "q" in errs:
            records[name]["q_max_abs_err"] = errs["q"]
        sms[with_jac] = k
        del p

    # extras_tangent on the kernel's q and grot
    sm = sms[True]
    datr_k = mj.extras_tangent(sm.q, sm.grot, tables)
    datr_p = mj.extras_tangent_plain(sm.q, sm.grot, tables)
    torch.cuda.synchronize()
    e_datr = max_err(datr_k, datr_p)
    scale = max(1.0, float(datr_p.abs().max()))
    log(f"  {mj.TANGENT}: datr {tuple(datr_k.shape)} max abs err "
        f"{e_datr:.3g} (scale {scale:.3g})")
    assert torch.isfinite(datr_k).all()
    assert e_datr <= TOL_SMALLS * scale, (mj.TANGENT, e_datr)
    # one PyTorch call of the same function: the chain sum and the rest-joint
    # term as one contraction over 2J stacked joints
    eye = torch.eye(J, device=theta.device)
    anc2 = torch.cat([tables.anc, -eye], 1)
    q2 = torch.cat([sm.q, sm.grot], 1)
    d2 = torch.cat([tables.dtrel, tables.djnt], 0)
    lib = lambda: torch.einsum("jk,fkab,keb->feja", anc2, q2, d2)
    assert max_err(lib(), datr_p) <= TOL_SMALLS * scale
    chain = float(np.sum(18 + 18 * chain_lengths(tables)))
    records[mj.TANGENT] = dict(
        max_abs_err=e_datr,
        **timed(lambda: mj.extras_tangent(sm.q, sm.grot, tables),
                lambda: mj.extras_tangent_plain(sm.q, sm.grot, tables)),
        library_ms=cuda_ms(lib, n=3),
        **bound((sm.q, sm.grot, tables.dtrel, tables.djnt, tables.parents_t),
                (datr_k,), F * E * chain),
        **extras_occupancy(tables, F),
        bucket_ms_device=bucket_ms(
            lambda n: mj.extras_tangent(sm.q[:n], sm.grot[:n], tables)))
    log_buckets(mj.TANGENT, records[mj.TANGENT])
    del q2, datr_p
    torch.cuda.empty_cache()

    uvs = {}
    for with_jac in (True, False):
        name, sm = mj._names(with_jac, "tiled")[1], sms[with_jac]
        sim_k, jm_k, uv_k = mj.marker_rows_tiled(sm, trans, vpshift, tables,
                                                 with_jac)
        sim_p, jm_p, uv_p = mj.marker_rows_tiled_plain(sm, trans, vpshift,
                                                       tables, with_jac)
        torch.cuda.synchronize()
        e_sim = max_err(sim_k, sim_p)
        e = e_sim
        assert torch.isfinite(sim_k).all(), name
        assert e_sim <= TOL_SIM, (name, "sim", e_sim)
        if with_jac:
            e_jm = max_err(jm_k[..., :Dp], jm_p[..., :Dp])
            scale = max(float(jm_p.abs().max()), 1.0)
            e_uv = max_err(uv_k, uv_p)
            scale_uv = max(float(uv_p.abs().max()), 1.0)
            log(f"  {name}: sim err {e_sim:.3g} m, jm[..., :{Dp}] err "
                f"{e_jm:.3g} (scale {scale:.3g}), uv err {e_uv:.3g} "
                f"(scale {scale_uv:.3g})")
            assert torch.isfinite(jm_k[..., :Dp]).all(), name
            assert torch.isfinite(uv_k).all(), name
            assert e_jm <= TOL_JM * scale, (name, "jm", e_jm)
            assert e_uv <= TOL_JM * scale_uv, (name, "uv", e_uv)
            e = max(e, e_jm, e_uv)
            uvs = dict(jm=jm_k, uv=uv_k)
            del jm_p
        else:
            log(f"  {name}: sim err {e_sim:.3g} m")
        f32, f64 = rows_flops(tables, F, with_jac, "tiled")
        written = (sim_k, jm_k[..., :Dp] if with_jac else None, uv_k)
        records[name] = dict(
            max_abs_err=e,
            **timed(lambda: mj.marker_rows_tiled(sm, trans, vpshift, tables,
                                                 with_jac),
                    lambda: mj.marker_rows_tiled_plain(sm, trans, vpshift,
                                                       tables, with_jac),
                    n_plain=2),
            **bound((*sm[:6], trans, vpshift, *rows_tables(tables, with_jac)),
                    written, f32, f64))
        torch.cuda.empty_cache()

    # extras_cols on the kernel route's datr and uv, then the whole route
    jm_k, uv_k = uvs["jm"], uvs["uv"]
    mj.extras_cols(datr_k, uv_k, tables, jm_k)
    jm_p = mj.extras_cols_plain(datr_k, uv_k, tables, jm_k.clone())
    torch.cuda.synchronize()
    e_cols = max_err(jm_k[..., Dp:], jm_p[..., Dp:])
    scale = max(float(jm_p.abs().max()), 1.0)
    log(f"  {mj.COLS}: jm[..., {Dp}:] err {e_cols:.3g} (scale {scale:.3g}), "
        f"|cols| max {float(jm_p[..., Dp:].abs().max()):.3g}")
    assert torch.isfinite(jm_k).all()
    assert e_cols <= TOL_JM * scale, (mj.COLS, e_cols)
    del jm_p
    w3, dv = tables.w3, tables.dv
    U = uv_k[..., :27].reshape(F, M, 3, 3, 3)
    V = uv_k[..., 27:].reshape(F, M, 3, 3, 3)
    # the same function in PyTorch: two einsum calls and an add (no single
    # call computes it)
    lib = lambda: (torch.einsum("fmkcd,mkj,fejd->fmce", U, w3, datr_k)
                   + torch.einsum("fmkcz,mkez->fmce", V, dv))
    assert max_err(lib(), jm_k[..., Dp:]) <= TOL_JM * scale
    nnz = float((w3 != 0).sum())
    records[mj.COLS] = dict(
        max_abs_err=e_cols,
        **timed(lambda: mj.extras_cols(datr_k, uv_k, tables, jm_k),
                lambda: mj.extras_cols_plain(datr_k, uv_k, tables, jm_k),
                n_plain=2),
        library_ms=cuda_ms(lib, n=2),
        **bound((datr_k, uv_k, tables.wnz_j, tables.wnz_w, tables.dvt),
                (jm_k[..., Dp:],), F * E * (6 * nnz + M * 3 * 36)),
        **extras_occupancy(tables, F, cols=True),
        bucket_ms_device=bucket_ms(
            lambda n: mj.extras_cols(datr_k[:n], uv_k[:n], tables, jm_k[:n])))
    log_buckets(mj.COLS, records[mj.COLS])
    del U, V, uvs, datr_k, uv_k
    torch.cuda.empty_cache()

    # the whole route, kernels against plain versions
    x = bp["x_true"]
    sim_k, jm_k = mj.marker_sim_and_jacobian(model, tables, x)
    sm_p = mj.fk_smalls_tiled_plain(theta, jshift, tables, True)
    sim_p, jm_p, uv_p = mj.marker_rows_tiled_plain(sm_p, trans, vpshift,
                                                   tables, True)
    datr_p = mj.extras_tangent_plain(sm_p.q, sm_p.grot, tables)
    jm_p = mj.extras_cols_plain(datr_p, uv_p, tables, jm_p)
    torch.cuda.synchronize()
    e_sim, e_jm = max_err(sim_k, sim_p), max_err(jm_k, jm_p)
    scale = max(float(jm_p.abs().max()), 1.0)
    log(f"  tiled route: sim err {e_sim:.3g} m, final jm {tuple(jm_k.shape)} "
        f"err {e_jm:.3g} (scale {scale:.3g})")
    assert e_sim <= TOL_SIM and e_jm <= TOL_JM * scale, (e_sim, e_jm)
    records["tiled route"] = dict(sim_err=e_sim, jm_err=e_jm, jm_scale=scale)
    del sm_p, jm_p, jm_k, uv_p, datr_p
    torch.cuda.empty_cache()


def check_fold_kernels(bp, records, x0, aux, phase):
    """The folded marker rows of the problem's route at its shapes, on the
    observations and the data weights of its rigid-init system (a few
    markers' w set to 0): against their plain versions, and against the
    unfolded kernel times w, which they must equal bit for bit on the
    weighted residual and on the trans, pose and inline columns (each
    multiply comes last in both); the tiled route's extra columns, summed
    from weighted chain factors, within TOL_JM. Timed beside the unfolded
    kernel plus the torch weighting pass of the unfolded system
    (`unfolded_ms`, the same function in two steps)."""
    import torch
    from moshpp_torch.ops import marker_jac as mj

    model, tables = bp["prob"].sub_model, bp["prob"].tables
    route = tables.route
    name = mj._names(True, route, True)[1]
    theta, trans, extra = mj.kernel_inputs(model, tables, x0)
    F, M, D, E = (theta.shape[0], tables.num_markers, tables.dof,
                  tables.n_extra)
    Dp = D - E if route == "tiled" else D     # columns the kernel writes
    obs = aux["markers"].contiguous()
    w = (aux["mask"] * aux["wt_data"][:, None]).contiguous()
    w[::97, 3] = 0.0
    w[5, :4] = 0.0
    wmax = float(w.max())
    weigh = lambda sim, jm: ((sim - obs) * w[..., None],
                             jm * w[..., None, None])
    log(f"phase {phase}: {name}, F={F}, M={M}, D={D}, w max {wmax:.1f}, "
        f"{int((w == 0).sum())} zero weights")
    if route == "tiled":
        jshift, vpshift = mj.extra_shifts(tables, extra)
        sm = mj.fk_smalls_tiled(theta, jshift, tables, True)
        kernel = lambda: mj.marker_rows_tiled_fold(sm, trans, vpshift, tables,
                                                   obs, w)
        plain = lambda: mj.marker_rows_tiled_fold_plain(sm, trans, vpshift,
                                                        tables, obs, w)
        unfolded_rows = lambda: mj.marker_rows_tiled(sm, trans, vpshift,
                                                     tables, True)
        read = (*sm[:6], trans, vpshift)
    else:
        sm = mj.fk_smalls(theta, tables, True, extra)
        kernel = lambda: mj.marker_rows_fold(sm, trans, tables, obs, w, extra)
        plain = lambda: mj.marker_rows_fold_plain(sm, trans, tables, obs, w,
                                                  extra)
        unfolded_rows = lambda: mj.marker_rows(sm, trans, tables, True, extra)
        read = (*sm[:6], sm.datr, trans, extra,
                tables.dv if extra is not None else None)
    out_k, out_p, out_u = kernel(), plain(), unfolded_rows()
    rw_u, jw_u = weigh(*out_u[:2])
    torch.cuda.synchronize()
    rw_k, jw_k = out_k[:2]
    assert torch.isfinite(rw_k).all() and torch.isfinite(jw_k[..., :Dp]).all()
    e_rw = max_err(rw_k, out_p[0])
    e_jw = max_err(jw_k[..., :Dp], out_p[1][..., :Dp])
    scale = max(float(out_p[1].abs().max()), 1.0)
    d_rw = max_err(rw_k, rw_u)
    d_jw = max_err(jw_k[..., :Dp], jw_u[..., :Dp])
    zero_jw = float(jw_k[..., :Dp][w == 0].abs().max())
    zero_rw = float(rw_k[w == 0].abs().max())
    line = (f"  {name}: vs plain rw err {e_rw:.3g} (limit {TOL_SIM * wmax:.3g}),"
            f" jw[..., :{Dp}] err {e_jw:.3g} (scale {scale:.3g}); vs the "
            f"unfolded kernel times w: rw {d_rw:.3g}, jw[..., :{Dp}] {d_jw:.3g}"
            f" (bit for bit: 0 required); zero-weight rows max "
            f"{max(zero_jw, zero_rw):.3g}")
    rec = dict(max_abs_err=max(e_rw, e_jw), vs_unfolded_rw=d_rw,
               vs_unfolded_jw=d_jw)
    if route == "tiled":
        uv_k, uv_p, uv_u = out_k[2], out_p[2], out_u[2]
        e_uv = max_err(uv_k, uv_p)
        d_uv = max_err(uv_k, uv_u * w[..., None])
        line += f"; uv vs plain {e_uv:.3g}, vs unfolded uv w {d_uv:.3g}"
        assert e_uv <= TOL_JM * max(float(uv_p.abs().max()), 1.0), (name, e_uv)
        rec.update(uv_err=e_uv, vs_unfolded_uv=d_uv)
    log(line)
    assert e_rw <= TOL_SIM * wmax and e_jw <= TOL_JM * scale, (name, rec)
    assert d_rw == 0.0 and d_jw == 0.0, (name, "not bit for bit", rec)
    assert zero_jw == 0.0 and zero_rw == 0.0, name
    del out_p, out_u, rw_u, jw_u
    if route == "tiled":
        # the whole folded route: the extra columns come from weighted uv
        rw_r, jw_r = mj.marker_resid_and_wjac(model, tables, x0, obs, w)
        rw_u, jw_u = weigh(*mj.marker_sim_and_jacobian(model, tables, x0))
        torch.cuda.synchronize()
        scale = max(float(jw_u.abs().max()), 1.0)
        e_cols = max_err(jw_r[..., Dp:], jw_u[..., Dp:])
        log(f"  folded tiled route: rw vs unfolded route {max_err(rw_r, rw_u):.3g}"
            f", jw[..., :{Dp}] {max_err(jw_r[..., :Dp], jw_u[..., :Dp]):.3g}, "
            f"extra columns {e_cols:.3g} (scale {scale:.3g})")
        assert torch.equal(rw_r, rw_u)
        assert torch.equal(jw_r[..., :Dp], jw_u[..., :Dp])
        assert e_cols <= TOL_JM * scale, e_cols
        rec["route_extra_cols_err"] = e_cols
        del rw_r, jw_r, rw_u, jw_u
    torch.cuda.empty_cache()
    f32, f64 = rows_flops(tables, F, True, route)
    written = (rw_k, jw_k[..., :Dp], out_k[2] if route == "tiled" else None)
    records[name] = dict(
        **rec, **timed(kernel, plain, n_plain=2),
        unfolded_ms=cuda_ms(lambda: weigh(*unfolded_rows()[:2])),
        unfolded_ms_device=cuda_ms(lambda: weigh(*unfolded_rows()[:2]),
                                   hold=True),
        library_ms=None,
        **bound((*read, *rows_tables(tables, True), obs, w), written,
                f32 + F * M * (3 * Dp + 9), f64))
    r = records[name]
    log(f"  {name}: {r['ms_device']:.4f} ms device ({r['ms']:.4f} host-"
        f"inclusive), unfolded kernel + weighting {r['unfolded_ms_device']:.4f}"
        f" ms device ({r['unfolded_ms']:.4f}), plain {r['plain_ms']:.3f} ms, "
        f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    del out_k, rw_k, jw_k, written
    torch.cuda.empty_cache()


def check_pcg(bp, records, g, B, pmask, phase):
    """`pcg_direction` at the problem's D against its plain version, at the
    solve's 24 and the polish's 128 iterations: on the real system at the
    rigid init, masked and damped as the solver would hand it over, and on
    `direction_test_system` cases at Jacobi-scaled condition ~5, ~1e2 and
    ~1e3. Each is held to the plain version in float64 within
    TOL_DIR_VS_F64 times the float32 plain version's largest distance over
    the given order and PERM_SEEDS permutations (the direction kernel's
    gate); at ~5 also elementwise to the float32 plain version; the ok
    flags must equal the float64 version's wherever its g.p_gn is clearly
    negative. Returns the launches of its entry point `pcg_direction_batched`
    once per iteration count on the real system, counted alone."""
    import torch
    from moshpp_torch import kernels
    from moshpp_torch.solver import gauss_newton as gn
    from moshpp_torch.solver import pcg

    opts = bp["opts"]
    F, D = g.shape
    Bd = gn._damp(gn._masked_system(g, B, pmask)[1],
                  gn.DoglegOptions()).contiguous()
    plin = torch.zeros_like(g)
    iters_list = (opts.cg_iters, opts.cg_iters_polish)
    kernels.COUNTS.reset()
    for iters in iters_list:                  # the entry point, counted
        pcg.pcg_direction_batched(g, Bd, plin, iters)
    torch.cuda.synchronize()
    launches = kernels.COUNTS.launches[pcg.PCG_KERNEL]
    log(f"phase {phase}: pcg_direction@D{D}, F={F}: {launches} launches of "
        f"pcg_direction_batched on the real system (no solve calls it)")

    def gate(tag, args, iters, elementwise):
        p_k, ok_k = pcg.pcg_direction_batched(*args, iters)
        orders = pcg.pcg_plain_in_orders(*args, iters, PERM_SEEDS)
        p_64, ok_64 = pcg.pcg_direction_plain(*(t.double() for t in args),
                                              iters)
        torch.cuda.synchronize()
        e_k = max_err(p_k.double(), p_64)
        e_orders = [max_err(o[0].double(), p_64) for o in orders]
        g64 = args[0].double()
        gp = (g64 * p_64).sum(-1)
        clear = gp < -1e-3 * (torch.linalg.vector_norm(g64, dim=-1)
                              * torch.linalg.vector_norm(p_64, dim=-1))
        ok_bad = int((ok_k[clear] != ok_64[clear]).sum())
        line = (f"  pcg_direction@D{D} {tag}: |kernel-f64| {e_k:.3g}, |plain "
                f"f32-f64| {', '.join(f'{e:.3g}' for e in e_orders)} (given "
                f"order, then permuted), |f64| max "
                f"{float(p_64.abs().max()):.3g}; ok {int(ok_k.sum())} of {F} "
                f"(f64 {int(ok_64.sum())}), {int(clear.sum())} clear descents,"
                f" {ok_bad} ok flags differ there")
        if elementwise:
            p32, ok32 = orders[0]
            bad = int(((p_k - p32).abs() > TOL_DIR_ATOL
                       + TOL_DIR_RTOL * p32.abs()).sum())
            line += f"; vs plain f32 {bad} of {p_k.numel()} outside"
            assert bad == 0 and torch.equal(ok_k, ok32), ("pcg", D, tag)
        log(line)
        assert torch.isfinite(p_k).all(), ("pcg", D, tag)
        assert e_k <= TOL_DIR_VS_F64 * max(e_orders) + 1e-6 * float(
            p_64.abs().max()), ("pcg", D, tag)
        assert ok_bad == 0, ("pcg", D, tag, "ok")
        return e_k

    errs = []
    for cond in (5.0, 1e2, 1e3):
        g_t, B_t, plin_t, mask_t, _ = pcg.direction_test_system(
            F, D, cond, seed=1, device=g.device)
        gm, Bm = gn._masked_system(g_t, B_t, mask_t)
        args = (gm.contiguous(),
                gn._damp(Bm, gn.DoglegOptions(damping=1e-8)).contiguous(),
                (plin_t * mask_t).contiguous())
        del g_t, B_t, Bm
        for iters in iters_list:
            errs.append(gate(f"cond ~{cond:g} iters={iters}", args, iters,
                             cond == 5.0))
        del args
        torch.cuda.empty_cache()
    for iters in iters_list:
        errs.append(gate(f"iters={iters} (real B)", (g, Bd, plin), iters,
                         False))
        out = pcg.pcg_direction_batched(g, Bd, plin, iters)
        # per frame: iters + 1 matvecs of 2 D^2, ~10 D more an iteration
        records[f"pcg_direction@D{D}@{iters}"] = dict(
            **timed(lambda: pcg.pcg_direction_batched(g, Bd, plin, iters),
                    lambda: pcg.pcg_direction_plain(g, Bd, plin, iters),
                    n_plain=2),
            library_ms=None,
            **bound((g, Bd, plin), out,
                    F * ((iters + 1) * 2 * D * D + iters * 10 * D)))
        r = records[f"pcg_direction@D{D}@{iters}"]
        log(f"  pcg_direction@D{D}@{iters}: {r['ms_device']:.4f} ms device "
            f"({r['ms']:.4f} host-inclusive), plain {r['plain_ms']:.3f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    records[f"pcg_direction@D{D}"] = dict(
        max_abs_err=max(errs), launches=launches,
        **records[f"pcg_direction@D{D}@{opts.cg_iters}"])
    del Bd
    torch.cuda.empty_cache()
    return launches


def rigid_init_system(bp):
    """The problem's first system as the solver assembles it: x0 at the
    rigid init, its aux (the data weights of the observed markers, the
    anchor pass's prior scale 10), the masked gradient g, the raw B and the
    step-2 parameter mask, all (F, ..)."""
    import torch
    from moshpp_torch.pipeline import stageii

    prob, opts = bp["prob"], bp["opts"]
    F = bp["obs"].shape[0]
    P, E = prob.sub_model.pose_dof, prob.tables.n_extra
    maskf = bp["mask"].to(torch.float32)
    x0 = stageii.rigid_init(prob, opts, bp["obs"], maskf)
    system = stageii.make_stageii_system(prob, opts, bp["prior"],
                                         bp["model_type"])
    n_obs = maskf.sum(1)
    aux = {"markers": bp["obs"], "mask": maskf,
           "wt_data": opts.wt("data") * 46.0 / n_obs.clamp(min=1.0),
           "anneal": torch.ones(F, device=x0.device),
           "wt_pose_scale": torch.full((F,), 10.0, device=x0.device),
           "velo_anchor": torch.zeros_like(x0[:, 3:3 + P]),
           "velo_on": torch.zeros(F, device=x0.device)}
    if E:
        aux.update(extra_anchor=torch.zeros_like(x0[:, 3 + P:]),
                   extra_on=torch.zeros(F, device=x0.device))
    _, g, B = system.system_fn(x0, aux)
    _, step2 = stageii._param_masks(prob.sub_model, opts, bp["model_type"],
                                    x0.device)
    pmask = step2.expand_as(g).contiguous()
    return x0, aux, (g * pmask).contiguous(), B, pmask


def check_direction(bp, records, suffix=""):
    """The direction kernel against its plain version at the problem's D:
    on B from the real assembly at the rigid init and on synthetic systems
    of the same shape. Records its entries under `dogleg_direction<suffix>`
    ("" on the E=0 path, "@D125" on the DMPL path, "@D206" on the face
    path)."""
    import torch
    from moshpp_torch.solver import gauss_newton, pcg

    opts = bp["opts"]
    F = bp["obs"].shape[0]
    _, _, g, B, pmask = rigid_init_system(bp)
    D = g.shape[1]
    plin = torch.zeros_like(g)
    delta = torch.full((F,), 0.5, device=g.device)
    log(f"  dogleg_direction{suffix}: F={F}, D={D}, B takes {D * D * 4} B "
        f"of shared memory a frame")

    # (i) synthetic systems of the path's shape (pcg.direction_test_system:
    # all three dogleg branches, warm starts taken and refused, masked
    # unknowns) at Jacobi-scaled condition ~5, ~1e2 and ~1e3. The kernel is
    # held to the plain version run in float64 on the same inputs, within
    # TOL_DIR_VS_F64 times the float32 plain version's own distance from it
    # (the largest over three summation orders): at ~1e2 and ~1e3 CG has not
    # converged after 24 iterations, so a wrong recurrence, preconditioner,
    # warm start or iteration count lands 100x or more farther off
    # (PERF.md). At ~5 CG converges, and the kernel must
    # also meet the elementwise tolerances against the float32 plain version.
    def held_to_f64(tag, out_k, out_p, out_64, args, iters,
                    elementwise=False):
        """Gate (p, p_gn, pred) of the kernel on the float64 plain run,
        against the float32 plain version's largest distance over the given
        order (`out_p`) and the PERM_SEEDS orders of `args`; with
        `elementwise`, also on the float32 plain run. Returns the kernel's
        and the float32 plain version's (given order) distances in p."""
        perms = pcg.plain_in_orders(*args, iters, 1e-8, PERM_SEEDS)[1:]
        torch.cuda.synchronize()
        for i, (nm, k, p, r) in enumerate(zip(("p", "p_gn", "pred"), out_k,
                                              out_p, out_64)):
            e_k, e_p = max_err(k.double(), r), max_err(p.double(), r)
            e_perm = [max_err(o[i].double(), r) for o in perms]
            e_ref = max(e_p, *e_perm)
            if nm == "p":
                dist = (e_k, e_p)
            line = (f"  dogleg_direction{suffix} {tag} {nm}: |kernel-f64| "
                    f"{e_k:.3g}, |plain f32-f64| {e_p:.3g} (other orders "
                    f"{', '.join(f'{e:.3g}' for e in e_perm)}), |f64| max "
                    f"{float(r.abs().max()):.3g}")
            if elementwise:
                rtol, atol = ((TOL_PRED_RTOL, 1e-6) if nm == "pred"
                              else (TOL_DIR_RTOL, TOL_DIR_ATOL))
                bad = int(((k - p).abs() > atol + rtol * p.abs()).sum())
                line += f"; vs plain f32 {bad} of {k.numel()} outside"
                assert bad == 0, ("dogleg_direction", suffix, tag, nm)
            log(line)
            assert e_k <= TOL_DIR_VS_F64 * e_ref + 1e-6 * float(r.abs().max()), (
                "dogleg_direction", suffix, tag, nm)
        return dist

    errs = []
    for cond in (5.0, 1e2, 1e3):
        sys_args = pcg.direction_test_system(F, D, cond, seed=1,
                                             device=g.device)
        for iters in (opts.cg_iters, opts.cg_iters_polish):
            e_k, e_p = held_to_f64(
                f"cond ~{cond:g} iters={iters}",
                pcg.dogleg_direction_batched(*sys_args, iters, 1e-8),
                pcg.dogleg_direction_plain(*sys_args, iters, 1e-8),
                pcg.dogleg_direction_plain(*(t.double() for t in sys_args),
                                           iters, 1e-8),
                sys_args, iters, elementwise=cond == 5.0)
            errs.append(e_k)
            records[f"dogleg_direction{suffix} cond {cond:g} @{iters}"] = dict(
                kernel_vs_f64=e_k, plain_f32_vs_f64=e_p)
        del sys_args

    # (ii) on the real system (cond ~1e7): what the dogleg relies on, for
    # both versions, and the kernel held to the float64 plain run as in (i);
    # there the float32 iterates are chaotic, so that gate is loose
    def model_pred(p):
        """-(2 g.p + p B_md p) recomputed from a step in float64."""
        gm, Bm = gauss_newton._masked_system(g.double(), B.double(),
                                             pmask.double())
        Bd = gauss_newton._damp(Bm, gauss_newton.DoglegOptions())
        p = p.double()
        return -(2.0 * (gm * p).sum(-1)
                 + (p * torch.bmm(Bd, p[..., None])[..., 0]).sum(-1))

    for iters in (opts.cg_iters, opts.cg_iters_polish):
        args = (g, B, plin, pmask, delta, iters, 1e-8)
        outs = {"kernel": pcg.dogleg_direction_batched(*args),
                "plain": pcg.dogleg_direction_plain(*args)}
        for who, (p, _, pred) in outs.items():
            norm = torch.linalg.vector_norm(p, dim=-1)
            pred64 = model_pred(p)
            floor = 1e-6 * float(pred64.abs().max())
            rel = float(((pred.double() - pred64).abs()
                         / (pred64.abs() + floor)).max())
            # g.p relative to |g||p|: a step that goes uphill in the model
            uphill = float(((g * p).sum(-1) / (
                torch.linalg.vector_norm(g, dim=-1) * norm + 1e-30)).max())
            log(f"  dogleg_direction{suffix} iters={iters} (real B, {who}): "
                f"|p| max {float(norm.max()):.4g} (radius 0.5), pred vs own "
                f"step rel {rel:.3g}, max cos(g, p) {uphill:.3g}, min pred "
                f"{float(pred.min()):.4g}")
            assert torch.isfinite(p).all() and torch.isfinite(pred).all(), who
            assert float(norm.max()) <= 0.5 * (1 + 1e-5), (who, "radius")
            assert rel <= TOL_PRED_RTOL, (who, "pred", rel)
            assert uphill <= 1e-6 and float(pred.min()) >= -floor, (who, "descent")
        out_64 = pcg.dogleg_direction_plain(*(t.double() for t in args[:5]),
                                            iters, 1e-8)
        held_to_f64(f"iters={iters} (real B)", outs["kernel"], outs["plain"],
                    out_64, args[:5], iters)
        # per frame: iters + 2 matvecs of 2 D^2, ~12 D more an iteration
        records[f"dogleg_direction{suffix}@{iters}"] = dict(
            **timed(lambda: pcg.dogleg_direction_batched(*args),
                    lambda: pcg.dogleg_direction_plain(*args), n_plain=2),
            **bound((g, B, plin, pmask, delta), outs["kernel"],
                    F * ((iters + 2) * 2 * D * D + iters * 12 * D)))
    records[f"dogleg_direction{suffix}"] = dict(
        max_abs_err=max(errs),
        **records[f"dogleg_direction{suffix}@{opts.cg_iters}"])


def cpu_solve(bp, opts, obs=None):
    """The CPU solve (plain versions) of a problem built on the CPU."""
    from moshpp_torch.pipeline import stageii
    return stageii.mosh_stageii_solve(
        bp["prob"], opts, bp["obs"] if obs is None else obs, bp["mask"],
        prior=bp["prior"], model_type=bp["model_type"], device="cpu")


def card_solve(bp, opts):
    """The card's solve (kernels) of a problem built on the CPU."""
    import torch
    from moshpp_torch.pipeline import stageii

    prob_c = bp["prob"]
    prob_g = stageii.problem_from_arrays(
        prob_c.sub_model, prob_c.indices.stacked.numpy(),
        prob_c.coeffs.numpy(), prob_c.betas.numpy(), opts, device="cuda")
    res = stageii.mosh_stageii_solve(prob_g, opts, bp["obs"].cuda(),
                                     bp["mask"].cuda(),
                                     prior=prior_on(bp, "cuda"),
                                     model_type=bp["model_type"],
                                     device="cuda")
    torch.cuda.synchronize()
    return res


def wander_mm(a, b) -> float:
    """The largest difference of any fitted marker coordinate, in mm."""
    return float((a.markers_sim.cpu() - b.markers_sim.cpu()).abs().max()) * 1e3


def compare_solves(res_c, res_g, t_cpu, t_gpu) -> dict:
    """The mean marker errors of a CPU and a card solve and their wander."""
    out = dict(err_cpu_mm=float(res_c.data_err.mean()) * 1e3,
               err_card_mm=float(res_g.data_err.mean()) * 1e3,
               max_wander_mm=wander_mm(res_g, res_c), cpu_s=t_cpu,
               card_s=t_gpu)
    assert np.isfinite(out["err_cpu_mm"]) and np.isfinite(out["err_card_mm"])
    return out


def perturbed_markers(make, frames: int, opts, seed: int) -> np.ndarray:
    """The fitted markers of the CPU solve of `make(frames, "cpu")` whose
    observations are moved by 1e-7 m of noise drawn from `seed`; runs in a
    worker process, which builds the problem from its seeds itself (sending
    the parent's tensors would move their storage into shared memory while
    the parent solves on them)."""
    import torch
    torch.set_num_threads(CPU_THREADS_PER_SOLVE)
    bp = make(frames, "cpu")
    noise = 1e-7 * torch.randn(bp["obs"].shape,
                               generator=torch.Generator().manual_seed(seed))
    return cpu_solve(bp, opts, bp["obs"] + noise).markers_sim.numpy()


def solve_both(bp, opts, floor_of=None):
    """Solve one problem on the CPU (plain versions) and on the card
    (kernels); the mean marker errors and the largest difference of any
    fitted marker coordinate (wander), in mm, and the CPU solve. With
    `floor`, also the largest wander between the CPU solve and CPU solves
    whose observations differ by 1e-7 m (FLOOR_SEEDS): the solve's own
    sensitivity to rounding. Those run in worker processes while this one
    solves, every CPU solve on CPU_THREADS_PER_SOLVE threads; `floor_of` is
    (make, frames), which built `bp`."""
    import torch

    if floor_of is None:
        t0 = time.perf_counter()
        res_c = cpu_solve(bp, opts)
        t_cpu = time.perf_counter() - t0
        t0 = time.perf_counter()
        res_g = card_solve(bp, opts)
        return compare_solves(res_c, res_g, t_cpu,
                              time.perf_counter() - t0), res_c
    threads = torch.get_num_threads()
    with ProcessPoolExecutor(len(FLOOR_SEEDS), mp_context=multiprocessing
                             .get_context("spawn")) as pool:
        pending = [pool.submit(perturbed_markers, *floor_of, opts, s)
                   for s in FLOOR_SEEDS]
        torch.set_num_threads(CPU_THREADS_PER_SOLVE)
        try:
            t0 = time.perf_counter()
            res_c = cpu_solve(bp, opts)
            t_cpu = time.perf_counter() - t0
        finally:
            torch.set_num_threads(threads)
        t0 = time.perf_counter()
        res_g = card_solve(bp, opts)
        out = compare_solves(res_c, res_g, t_cpu, time.perf_counter() - t0)
        sims = [p.result(timeout=1200) for p in pending]
    floors = [float(np.abs(sim - res_c.markers_sim.numpy()).max()) * 1e3
              for sim in sims]
    out["cpu_floor_wanders_mm"] = floors
    out["cpu_floor_wander_mm"] = max(floors)
    return out, res_c


def phase_parity(report, phase, problems):
    """Phases 3, 3b and 3c: the same problems solved on the CPU and on the
    card.

    Each entry of `problems` is (name, make, frames, floor). All must meet
    the mean bar. The reference parity problem runs at the reference's own
    size and settings (F=64, tight tolerances, where the JAX package
    measured 0.1-0.35 mm of wander between two of its own solves) and must
    meet the 0.6 mm wander bar. On the bench problem at F=256 that bar does
    not hold even between two solves of the JAX package (PERF.md), so its
    wander, and the DMPL and face problems' (`floor`), must stay within the larger of
    0.6 mm and FLOOR_FACTOR times the CPU's own floor measured in the same
    run (the largest wander between the CPU solve and CPU solves 1e-7 m
    apart in the observations, one per FLOOR_SEEDS). Problems with a floor
    polish through PCG on both sides. Returns, per problem with a floor,
    what phase 3d reuses: the problem, its options, the CPU solve and the
    floor."""
    kept = {}
    for name, make, frames, floor_gate in problems:
        bp = make(frames, "cpu")
        polish = dict(polish_solver="pcg") if floor_gate else {}
        opts = dataclasses.replace(bp["opts"], **polish)
        r, res_c = solve_both(bp, opts,
                              (make, frames) if floor_gate else None)
        r["wander_limit_mm"] = PARITY_WANDER_MM
        floor = ""
        if floor_gate:
            r["wander_limit_mm"] = max(
                PARITY_WANDER_MM, FLOOR_FACTOR * r["cpu_floor_wander_mm"])
            floor = (f", cpu-vs-cpu floor {r['cpu_floor_wander_mm']:.4f} mm "
                     f"(max of {[round(w, 4) for w in r['cpu_floor_wanders_mm']]})")
        log(f"phase {phase}: {name}, F={frames}: mean marker err cpu "
            f"{r['err_cpu_mm']:.4f} mm, card {r['err_card_mm']:.4f} mm, max "
            f"wander {r['max_wander_mm']:.4f} mm{floor}, limit "
            f"{r['wander_limit_mm']:.4f} mm (cpu {r['cpu_s']:.1f} s, card "
            f"{r['card_s']:.1f} s incl. first calls)")
        report[f"parity: {name}"] = dict(frames=frames, **r)
        assert abs(r["err_cpu_mm"] - r["err_card_mm"]) <= PARITY_MEAN_MM, r
        assert r["max_wander_mm"] <= r["wander_limit_mm"], r
        if floor_gate:
            kept[name] = dict(bp=bp, opts=opts, res_cpu=res_c,
                              floor_mm=r["cpu_floor_wander_mm"])
    return kept


def phase_fold_parity(report, phase, kept):
    """Phase 3d: the card's folded solve (`fold_weights`) of the bench, DMPL
    and face problems at F=256 against the CPU's, with phase 3's bars and
    the floors phases 3, 3b and 3c measured. At E=0 and inline the CPU's
    folded solve is its unfolded one bit for bit (the plain fold computes
    the system's own weighting; tests/test_torch_fold.py), so those phases'
    CPU solves serve; the face problem's tiled extra columns round
    differently folded, so it gets a CPU folded solve of its own."""
    for name, k in kept.items():
        bp, opts = k["bp"], dataclasses.replace(k["opts"], fold_weights=True)
        t_cpu, res_c = 0.0, k["res_cpu"]
        if bp["prob"].tables.route == "tiled":
            t0 = time.perf_counter()
            res_c = cpu_solve(bp, opts)
            t_cpu = time.perf_counter() - t0
        t0 = time.perf_counter()
        res_g = card_solve(bp, opts)
        r = compare_solves(res_c, res_g, t_cpu, time.perf_counter() - t0)
        r["cpu_floor_wander_mm"] = k["floor_mm"]
        r["wander_limit_mm"] = max(PARITY_WANDER_MM,
                                   FLOOR_FACTOR * k["floor_mm"])
        frames = bp["obs"].shape[0]
        log(f"phase {phase}: {name} folded, F={frames}: mean marker err cpu "
            f"{r['err_cpu_mm']:.4f} mm ({'own folded solve, ' if t_cpu else ''}"
            f"{t_cpu:.1f} s), card {r['err_card_mm']:.4f} mm, max wander "
            f"{r['max_wander_mm']:.4f} mm, floor {k['floor_mm']:.4f} mm, "
            f"limit {r['wander_limit_mm']:.4f} mm (card {r['card_s']:.1f} s)")
        report[f"parity folded: {name}"] = dict(frames=frames, **r)
        assert abs(r["err_cpu_mm"] - r["err_card_mm"]) <= PARITY_MEAN_MM, r
        assert r["max_wander_mm"] <= r["wander_limit_mm"], r


def phase_slice(bp, report, phase, names):
    """Phases 4, 4b and 4c: a path at the bench protocol, F=FRAMES. Every
    kernel in `names` must launch in the counted solve, and no plain version
    may run on CUDA."""
    import torch
    from moshpp_torch import kernels
    from moshpp_torch.models import lbs_forward
    from moshpp_torch.pipeline import stageii

    def solve():
        out = stageii.mosh_stageii_solve(bp["prob"], bp["opts"], bp["obs"],
                                         bp["mask"], prior=bp["prior"],
                                         model_type=bp["model_type"],
                                         device="cuda")
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    res = solve()                                          # warm-up
    log(f"phase {phase}: warm-up solve {time.perf_counter() - t0:.2f} s")
    times = []
    for i in range(TIMED_SOLVES):
        if i == TIMED_SOLVES - 1:
            # counts and peak memory of exactly one main-path solve
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            kernels.COUNTS.reset()
        t0 = time.perf_counter()
        res = solve()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    launches = dict(kernels.COUNTS.launches)
    plain_cuda = dict(kernels.COUNTS.plain_cuda)
    dt = statistics.median(times)
    err_mm = float(res.data_err.mean()) * 1e3

    model, prob, opts = bp["model"], bp["prob"], bp["opts"]
    P = model.pose_dof
    sub = np.linspace(0, FRAMES - 1, 64).astype(int)
    x_true = bp["x_true"][sub]
    E = x_true.shape[1] - 3 - P

    def shape(extra):
        """The subject's betas with the per-frame extras in their columns."""
        return stageii._betas_for_lbs(prob, opts, extra)

    v_true = lbs_forward(model, x_true[:, 3:3 + P], shape(x_true[:, 3 + P:]),
                         x_true[:, :3])
    v_sol = lbs_forward(model, res.pose[sub], shape(res.extra[sub]),
                        res.trans[sub])
    v2v = torch.linalg.vector_norm(v_sol - v_true, dim=-1)
    body_vert = torch.argmax(model.weights, dim=1) < 1 + model.info.body_pose_dof // 3
    v2v_body = float(v2v[:, body_vert].mean()) * 1e3
    # families without hands have no hand vertices
    v2v_hands = (float(v2v[:, ~body_vert].mean()) * 1e3
                 if bool((~body_vert).any()) else None)
    fps = FRAMES / dt
    out = dict(frames=FRAMES, solve_s=times, median_s=dt, frames_per_s=fps,
               mean_marker_err_mm=err_mm, v2v_body_mm=v2v_body,
               v2v_hands_mm=v2v_hands, host_syncs=res.host_syncs,
               peak_mem_gib=peak / 2**30, start_mem_gib=base / 2**30,
               launches=launches, plain_cuda=plain_cuda,
               fold_weights=opts.fold_weights)
    rms = lambda a, b: float(torch.sqrt(torch.mean((a - b) ** 2)))
    dmpl = ""
    if E and opts.optimize_dynamics:
        out["dmpl_rms"] = rms(res.extra, bp["x_true"][:, 3 + P:])
        dmpl = f"; DMPL rms err {out['dmpl_rms']:.4f}"
    elif E:
        out["expr_rms"] = rms(res.extra, bp["x_true"][:, 3 + P:])
        out["expr_true_rms"] = rms(bp["x_true"][:, 3 + P:], 0.0)
        out["jaw_rms"] = rms(res.pose[:, 66:69], bp["x_true"][:, 69:72])
        dmpl = (f"; expression rms err {out['expr_rms']:.4f} (truth rms "
                f"{out['expr_true_rms']:.4f}), jaw rms err "
                f"{out['jaw_rms']:.4f} rad")
    hands = "" if v2v_hands is None else f", hands {v2v_hands:.4f} mm"
    log(f"phase {phase}: F={FRAMES} solve {dt:.3f} s median of "
        f"{[round(t, 3) for t in times]} -> {fps:.1f} frames/s; mean marker "
        f"err {err_mm:.4f} mm; v2v body {v2v_body:.4f} mm{hands}{dmpl}; "
        f"host syncs per solve {res.host_syncs}; "
        f"peak device memory {peak / 2**30:.4f} GiB ({base / 2**30:.4f} GiB "
        f"allocated as it began)")
    log(f"  launches in one solve: {launches}; plain versions on CUDA: "
        f"{plain_cuda}")
    report[f"slice {phase}"] = out
    assert torch.isfinite(res.markers_sim).all() and torch.isfinite(res.pose).all()
    assert res.markers_sim.shape == bp["obs"].shape
    assert res.extra.shape == (FRAMES, E) and torch.isfinite(res.extra).all()
    for name in names:
        assert launches.get(name, 0) > 0, f"{name} never launched in the solve"
    assert sum(plain_cuda.values()) == 0, plain_cuda
    assert err_mm <= MAX_MEAN_ERR_MM, err_mm
    return launches


# the families' parity runs at the reference parity problem's size
FAMILY_PARITY_FRAMES = 64
# (label, problem, phase letter) of the families beyond SMPL+H / SMPL-X
FAMILIES = (("horse", horse_problem, "e"), ("dog", dog_problem, "f"),
            ("object", object_problem, "g"))


def phase_family(label, make, letter, report, records):
    """Phases 2e-4e (horse), 2f-4f (dog), 2g-4g (object): the five
    main-path kernels at the family's shapes against their plain versions
    (recorded as `<name>@<label>`), CPU-vs-card parity at
    FAMILY_PARITY_FRAMES with the CPU floor gate of phases 3b-3c, and the
    F=FRAMES slice. Returns the slice's launches."""
    import torch
    t0 = time.perf_counter()
    bp = make(FRAMES, "cuda")
    t = bp["prob"].tables
    log(f"{label} problem: {bp['model_type']}, "
        f"{bp['model'].v_template.shape[0]} verts, J={t.num_joints}, "
        f"P={bp['model'].pose_dof}, D={t.dof}, featN={t.feat_n}, "
        f"M={t.num_markers}, F={FRAMES}, prior "
        f"{type(bp['prior']).__name__} ({time.perf_counter() - t0:.1f} s)")
    suffix = f"@{label}"
    check_marker_kernels(bp, records, "2" + letter, suffix)
    check_direction(bp, records, suffix)
    torch.cuda.empty_cache()
    phase_parity(report, "3" + letter, (
        (f"{label} problem", make, FAMILY_PARITY_FRAMES, True),))
    counts = phase_slice(bp, report, "4" + letter, TPU_KERNELS)
    del bp
    torch.cuda.empty_cache()
    return counts


# ~5.5 min at 120 Hz: an AMASS-length capture, past the default chunk size
LONG_FRAMES = 40_000
CHUNK_MEAN_MM = 0.05   # tests/test_pipeline.py's chunked-vs-unchunked bar
CHUNK_SEAM_MM = 1.0


def phase_long(report, frames=LONG_FRAMES, device="cuda"):
    """Phase 5: the bench problem at LONG_FRAMES on the card, solved in one
    batch and in chunks (the default chunk_frames and chunk_halo, with a
    checkpoint directory), then the chunked solve again from its
    checkpoints. Gates: the chunked run launches the five main-path
    kernels; its mean marker error within CHUNK_MEAN_MM of the unchunked
    solve's and within MAX_MEAN_ERR_MM; its largest marker deviation from
    the unchunked solve on the seam frames (H either side of each seam)
    within max(CHUNK_SEAM_MM, FLOOR_FACTOR x the wander between two
    unchunked solves whose observations differ by 1e-7 m); the rerun makes
    no inner solve (no launch, no host sync) and returns the first run's
    arrays bit for bit. Returns the chunked run's launches."""
    import tempfile
    import torch
    from moshpp_torch import kernels
    from moshpp_torch.pipeline import stageii

    t0 = time.perf_counter()
    bp = bench_problem(frames, device)
    opts = bp["opts"]
    C, H = opts.chunk_frames, opts.chunk_halo
    seams = list(range(C, frames, C))
    log(f"phase 5: bench problem at F={frames}, chunk_frames={C}, "
        f"chunk_halo={H}: {len(seams) + 1} chunks of {C + 2 * H} frames "
        f"({time.perf_counter() - t0:.1f} s to build)")

    def solve(o, obs):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = stageii.mosh_stageii_solve(bp["prob"], o, obs, bp["mask"],
                                         prior=bp["prior"],
                                         model_type=bp["model_type"],
                                         device=device)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, torch.cuda.max_memory_allocated()

    whole = dataclasses.replace(opts, chunk_frames=0)
    res_full, t_full, mem_full = solve(whole, bp["obs"])
    noise = 1e-7 * torch.randn(bp["obs"].shape, generator=torch.Generator()
                               .manual_seed(FLOOR_SEEDS[0]))
    res_full2, t_full2, _ = solve(whole, bp["obs"] + noise.to(device))
    with tempfile.TemporaryDirectory() as ckpt:
        chunked = dataclasses.replace(opts, checkpoint_dir=ckpt)
        kernels.COUNTS.reset()
        res_c, t_chunk, mem_chunk = solve(chunked, bp["obs"])
        launches = dict(kernels.COUNTS.launches)
        plain_cuda = dict(kernels.COUNTS.plain_cuda)
        files = sorted(os.listdir(ckpt))
        kernels.COUNTS.reset()
        res_r, t_resume, _ = solve(chunked, bp["obs"])
        resume_launches = sum(kernels.COUNTS.launches.values())
    seam_ids = torch.as_tensor(np.concatenate(
        [np.arange(s - H, s + H) for s in seams]), device=device)

    def dev_mm(a, b, ids=None):
        d = (a.markers_sim - b.markers_sim).abs()
        return float((d if ids is None else d[ids]).max()) * 1e3

    err = lambda r: float(r.data_err.mean()) * 1e3
    out = dict(
        frames=frames, chunk_frames=C, chunk_halo=H,
        chunks=len(seams) + 1, checkpoint_files=files,
        unchunked_s=t_full, unchunked_perturbed_s=t_full2, chunked_s=t_chunk,
        resume_s=t_resume, peak_mem_gib_unchunked=mem_full / 2**30,
        peak_mem_gib_chunked=mem_chunk / 2**30,
        err_unchunked_mm=err(res_full), err_chunked_mm=err(res_c),
        host_syncs_unchunked=res_full.host_syncs,
        host_syncs_chunked=res_c.host_syncs,
        host_syncs_resume=res_r.host_syncs,
        seam_dev_mm=dev_mm(res_c, res_full, seam_ids),
        all_dev_mm=dev_mm(res_c, res_full),
        floor_mm=dev_mm(res_full2, res_full),
        floor_seam_mm=dev_mm(res_full2, res_full, seam_ids),
        launches=launches, plain_cuda=plain_cuda,
        resume_launches=resume_launches)
    out["seam_limit_mm"] = max(CHUNK_SEAM_MM, FLOOR_FACTOR * out["floor_mm"])
    out["bit_for_bit"] = all(
        torch.equal(getattr(res_c, f), getattr(res_r, f))
        for f in stageii.StageIIResult._fields[:-1])
    log(f"phase 5: unchunked {t_full:.2f} s ({frames / t_full:.1f} "
        f"frames/s, peak {mem_full / 2**30:.3f} GiB, {res_full.host_syncs} "
        f"host syncs), chunked {t_chunk:.2f} s ({frames / t_chunk:.1f} "
        f"frames/s, peak {mem_chunk / 2**30:.3f} GiB, {res_c.host_syncs} host "
        f"syncs), resumed from {len(files)} checkpoints in {t_resume:.3f} s "
        f"({resume_launches} launches, {res_r.host_syncs} host syncs, bit for "
        f"bit {out['bit_for_bit']})")
    log(f"phase 5: mean marker err unchunked {out['err_unchunked_mm']:.4f} "
        f"mm, chunked {out['err_chunked_mm']:.4f} mm; chunked vs unchunked "
        f"max marker deviation on the {len(seam_ids)} seam frames "
        f"{out['seam_dev_mm']:.4f} mm (all frames {out['all_dev_mm']:.4f}), "
        f"floor (unchunked vs unchunked 1e-7 m apart) {out['floor_mm']:.4f} mm"
        f" (seam frames {out['floor_seam_mm']:.4f}), limit "
        f"{out['seam_limit_mm']:.4f} mm")
    log(f"  launches in the chunked solve: {launches}")
    report["long sequence 5"] = out
    for r in (res_full, res_c):
        assert torch.isfinite(r.markers_sim).all() and torch.isfinite(r.pose).all()
        assert r.markers_sim.shape == bp["obs"].shape
    for name in TPU_KERNELS:
        assert launches.get(name, 0) > 0, f"{name} never launched in phase 5"
    assert sum(plain_cuda.values()) == 0, plain_cuda
    assert files == [f"chunk_{s:09d}.npz" for s in range(0, frames, C)]
    assert abs(out["err_chunked_mm"] - out["err_unchunked_mm"]) <= CHUNK_MEAN_MM
    assert max(out["err_chunked_mm"], out["err_unchunked_mm"]) <= MAX_MEAN_ERR_MM
    assert out["seam_dev_mm"] <= out["seam_limit_mm"], out
    assert resume_launches == 0 and res_r.host_syncs == 0, out
    assert out["bit_for_bit"], "the resumed solve differs from the first"
    del bp, res_full, res_full2, res_c, res_r
    torch.cuda.empty_cache()
    return launches


# ---- stage i (phase 6) -----------------------------------------------------
# tools/bench_stagei.py's protocol: full-width synthetic SMPL+H
# (num_verts=6890, the icosphere's 10242; dof_per_hand=24, P=114; 16
# betas), 46 markers at 9.5 mm off the skin, 12 frames with body poses drawn
# from an 8-component GMM, the 4-step annealing at maxiter=100
STAGEI_FRAMES = 12
STAGEI_SUBJECTS = 8
# the CPU-vs-card parity solve (6b): 4 frames and maxiter=40 keep the CPU
# solve short. Its floor is the JAX package's: the largest difference of
# the mean data error and of the latents (max, mm) between JAX's solve of
# this problem (JAX_PARITY_ERR_MM) and its solves with the observations
# moved by 1e-7 m (seeds 7-16: 6.0349-6.7764 mm). The reference's spread,
# not the port's own: a floor drawn from the code under test would widen
# with a fault that made it more chaotic. Every JAX reference of phase 6 is
# measured on this script's own worlds (`tools/stagei_reference.py
# --port-world`, on the CPU; here `--frames 4 --maxiter 40 --seeds 10`):
# where two vertices tie within float32 rounding the packages may give a
# marker other frame vertices than `tools/bench_stagei.py`'s world does,
# and one such marker moves JAX's 6c solve from 6.4758 to 5.3403 mm.
STAGEI_PARITY_FRAMES = 4
STAGEI_PARITY_MAXITER = 40
JAX_PARITY_ERR_MM = 6.1503
JAX_PARITY_ERR_SPREAD_MM = 0.6261
JAX_PARITY_LAT_SPREAD_MM = 15.4036
# tests/test_goldens.py:55-62's stage-i outcome bars (mm)
STAGEI_MEAN_MM, STAGEI_LATENT_MM = 0.1, 0.5
# 6c's mean data error by the JAX package on this problem, and the largest
# difference between that solve and the JAX solves whose observations are
# moved by 1e-7 m (seeds 7-16: 5.3326-6.1774 mm), in mm, from
# `tools/stagei_reference.py --port-world --seeds 10` on the CPU
JAX_STAGEI_ERR_MM = 5.3403
JAX_STAGEI_SPREAD_MM = 0.8371
STAGEI_REF_MM = 0.5
# 6d's reference: the JAX package's batched solve of the 8 subjects and
# each subject's single solve, on this script's worlds
# (`tools/stagei_reference.py --port-world --subjects 8 --seeds 0`), and
# each subject's spread, the largest difference of a batched solve with the
# observations moved by 1e-7 m (seeds 7-9) from the unperturbed one, on
# tools/bench_stagei.py's worlds (`... --subjects 8 --seeds 3`: a noisy
# batch takes an hour on the CPU; subjects 0, 5 and 6 differ there by one
# marker's frame), in mm, on the CPU. On its own worlds JAX's batched solve
# misses tests/test_pipeline.py:231's bar on subject 7 (16.0648 mm against
# 6.988 mm single).
JAX_BATCHED_ERR_MM = (5.6956, 7.3582, 7.3241, 11.6531, 13.4475, 5.5524,
                      8.1814, 11.0261)
JAX_BATCHED_SPREAD_MM = (0.4645, 4.3537, 1.8581, 3.0823, 2.0129, 0.9197,
                         2.6774, 8.6678)
JAX_SINGLE_ERR_MM = (5.3403, 8.6991, 7.2193, 11.4976, 12.0464, 6.2087,
                     9.3031, 11.0029)
# the step's check (6a, `check_stagei_step`): the state moved by this much
# seeded noise; the card's r, J, g and B within max(STEP_TOL
# (tests/test_goldens.py's probe tolerance), STEP_FACTOR x the CPU float32
# step's own distance) of the float64 step (on an H100 the card's B read
# 3.06e-4 from the CPU's float32 B, whose Jacobian columns lie 4.33e-3 from
# float64)
STAGEI_STEP_SHIFT = 1e-3
STAGEI_STEP_TOL = 2e-4
STAGEI_STEP_FACTOR = 4.0


def stagei_model(device):
    """tools/bench_stagei.py's model and prior on `device`."""
    from moshpp_torch.models import make_synthetic_model
    from moshpp_torch.priors.gmm import make_gmm_prior
    model = make_synthetic_model("smplh", num_verts=6890, seed=3,
                                 dof_per_hand=24, device=device)
    prior = make_gmm_prior(dim=63, num_components=8, seed=1, scale=0.3,
                           device=device)
    return model, prior


def stagei_world(seed, frames, model, prior):
    """One subject of tools/bench_stagei.py (`_make_world`, the same numpy
    draws) built with the port on the CPU: the layout vertices, true betas
    and latent markers, poses (body from the prior, a free root, mild hand
    PCA), trans and the observed markers (numpy)."""
    import torch
    from moshpp_torch.models import lbs_forward
    from moshpp_torch.ops.marker_transform import (marker_coeffs,
                                                   reconstruct_markers,
                                                   select_frame_indices)
    from moshpp_torch.ops.surface import vertex_normals
    from moshpp_torch.priors.gmm import sample_gmm_prior

    rng = np.random.default_rng(seed)
    V = model.v_template.shape[0]
    vids = np.random.default_rng(0).choice(V, MARKERS, replace=False)
    betas = (rng.normal(size=16) * 0.4).astype(np.float32)
    bt = torch.as_tensor(betas)
    can_v = model.v_template + torch.einsum(
        "vcb,b->vc", model.shapedirs[..., :16], bt)
    vn = vertex_normals(can_v, model.faces)
    latents = can_v[vids] + vn[vids] * 0.0095
    idx = select_frame_indices(can_v, latents)
    coeffs = marker_coeffs(can_v, latents, idx)
    P = model.pose_dof
    poses = np.zeros((frames, P), np.float32)
    poses[:, 3:66] = sample_gmm_prior(prior, rng, frames)
    poses[:, :3] = rng.normal(size=(frames, 3)) * 0.3
    poses[:, 66:] = rng.normal(size=(frames, P - 66)) * 0.05
    trans = (rng.normal(size=(frames, 3)) * 0.1).astype(np.float32)
    obs = reconstruct_markers(lbs_forward(model, torch.as_tensor(poses), bt,
                                          torch.as_tensor(trans)),
                              idx, coeffs)
    return dict(vids=vids, betas=betas, latents=latents.numpy(), poses=poses,
                trans=trans, obs=obs.numpy(),
                mask=np.ones((frames, MARKERS), bool))


def stagei_args(world, maxiter=100):
    """(positional, keyword) arguments of a stage-i solve of `world`, but
    the model, the prior and the device."""
    from moshpp_torch.pipeline.stagei import StageIOptions
    labels = [f"M{i:02d}" for i in range(MARKERS)]
    return ((labels, world["vids"], np.full(MARKERS, 0.0095, np.float32),
             {"body": np.ones(MARKERS, bool)}),
            dict(opts=StageIOptions(maxiter=maxiter)))


def stagei_solve(world, model, prior, device, maxiter=100):
    import torch
    from moshpp_torch.pipeline.stagei import mosh_stagei_solve
    args, kw = stagei_args(world, maxiter)
    res = mosh_stagei_solve(model, world["obs"], world["mask"], *args,
                            prior=prior, device=device, **kw)
    if device != "cpu":
        torch.cuda.synchronize()
    return res


def stagei_recovery(model, world, res) -> dict:
    """tools/bench_stagei.py:93-126's recovery metrics: betas RMS, latent
    error (mean, mm), vid-snap hit rate and the snapped vertices' distance
    from the true ones on the template (mm), and v2v over the frames (mm)."""
    import torch
    from moshpp_torch.models import lbs_forward
    cpu = lambda t: t.detach().cpu()
    betas_rms = float(np.sqrt(np.mean((cpu(res.betas).numpy()
                                       - world["betas"]) ** 2)))
    lat_mm = float(np.mean(np.linalg.norm(
        cpu(res.markers_latent).numpy() - world["latents"], axis=-1))) * 1e3
    snap = np.array([res.markers_latent_vids[l] for l in res.latent_labels])
    cv = cpu(model.v_template).numpy()
    dev = model.device
    v_true = lbs_forward(model, torch.as_tensor(world["poses"], device=dev),
                         torch.as_tensor(world["betas"], device=dev),
                         torch.as_tensor(world["trans"], device=dev))
    v_sol = lbs_forward(model, res.poses, res.betas, res.trans)
    return dict(
        betas_rms=betas_rms, latent_err_mm=lat_mm,
        vid_snap_hit_rate=float(np.mean(snap == world["vids"])),
        vid_snap_dist_mm=float(np.mean(np.linalg.norm(
            cv[snap] - cv[world["vids"]], axis=-1))) * 1e3,
        v2v_mm=float(torch.linalg.vector_norm(v_sol - v_true, dim=-1).mean())
        * 1e3)


def _rel_err(a, b) -> float:
    """The largest |a - b| over the largest |b| (at least 1e-30)."""
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def stagei_float64(ctx, fz):
    """A stage-i context and frozen structure in float64: the model, the
    GMM prior, the context's arrays and the structure's rows."""
    import torch
    d = lambda t: (t.double() if isinstance(t, torch.Tensor)
                   and t.is_floating_point() else t)
    cast = lambda obj: dataclasses.replace(obj, **{
        f.name: d(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    ctx64 = ctx._replace(model=cast(ctx.model), prior=cast(ctx.prior), **{
        k: d(v) for k, v in ctx._asdict().items()
        if isinstance(v, torch.Tensor)})
    return ctx64, {k: d(v) for k, v in fz.items()}


def stagei_step(ctx, fz, x, anneal, detailed):
    """(r, J, g = Jᵀr, B = JᵀJ) of one annealing step at x through the
    frozen structure `fz`, J by jacfwd, products in full float32."""
    import torch
    from moshpp_torch.pipeline import stagei
    rf = stagei._stagei_residual_fn(ctx, anneal, detailed)
    with stagei.fp32_matmul():
        J = torch.func.jacfwd(lambda xx: rf(xx, fz))(x)
        r = rf(x, fz)
        return r, J, J.T @ r, J.T @ J


def stagei_column_err(J, ref) -> float:
    """The largest |J - ref| of a column over that column's largest |ref|."""
    J, ref = J.detach().cpu().double(), ref.detach().cpu().double()
    return float(((J - ref).abs().amax(0)
                  / ref.abs().amax(0).clamp(min=1e-12)).max())


def check_stagei_step(ctx_c, fz_c, x_c, ctx_g, device):
    """One undetailed (anneal 1) and one detailed (anneal 0.25) annealing
    step at x_c moved by STAGEI_STEP_SHIFT of seeded noise, on the card
    (`ctx_g`) and on the CPU through the CPU's frozen structure, each held
    to the same step in float64 on the CPU. The init state itself lies on
    the distance function's ridges (a latent marker sits on its vertex's
    normal, where the faces around the vertex tie and the surface rows'
    derivative jumps between them), the moved state off them. r, g and B
    (relative to the largest float64 magnitude) and the Jacobian (column by
    column, relative to the column's largest float64 entry) on the card
    within max(STAGEI_STEP_TOL, STAGEI_STEP_FACTOR x the CPU float32's own
    distance from float64): the surface rows carry a weight of 1e4, and the
    float32 difference of a marker and its closest point ~1 m from the
    origin sets that distance. Returns the readings by step."""
    import torch
    shift = torch.as_tensor(np.random.default_rng(0).normal(
        size=x_c.shape[0]) * STAGEI_STEP_SHIFT, dtype=x_c.dtype)
    x = x_c + shift
    fz_g = {k: v.to(device) for k, v in fz_c.items()}
    ctx64, fz64 = stagei_float64(ctx_c, fz_c)
    out = {}
    for anneal, detailed in ((1.0, False), (0.25, True)):
        t0 = time.perf_counter()
        cpu = stagei_step(ctx_c, fz_c, x, anneal, detailed)
        t_c = time.perf_counter() - t0
        ref = stagei_step(ctx64, fz64, x.double(), anneal, detailed)
        t0 = time.perf_counter()
        card = stagei_step(ctx_g, fz_g, x.to(device), anneal, detailed)
        if device != "cpu":
            torch.cuda.synchronize()
        t_g = time.perf_counter() - t0
        step = dict(rows=int(cpu[0].shape[0]), dof=int(x.shape[0]),
                    cpu_s=t_c, card_s=t_g)
        for name, c, a, r in zip("rJgB", cpu, card, ref):
            assert torch.isfinite(a).all(), name
            err = stagei_column_err if name == "J" else _rel_err
            step[name] = dict(card=err(a, r), cpu=err(c, r),
                              card_vs_cpu=err(a, c))
            step[name]["limit"] = max(STAGEI_STEP_TOL, STAGEI_STEP_FACTOR
                                      * step[name]["cpu"])
        out[f"anneal {anneal}"] = step
        for name in "rJgB":
            assert step[name]["card"] <= step[name]["limit"], (name, step)
    return out


def phase_stagei_step(report, model_c, prior_c, model_g, prior_g, world,
                      device="cuda"):
    """Phase 6a: the 6c problem's init state on the card against the CPU,
    the card's own frozen structure against the CPU's (candidate faces as
    sets), and `check_stagei_step`."""
    from moshpp_torch.pipeline import stagei

    args, kw = stagei_args(world)
    ctxs = {}
    for dev, m, p in (("cpu", model_c, prior_c), (device, model_g, prior_g)):
        ctxs[dev] = stagei.prepare_stagei_context(
            m, world["obs"], world["mask"], *args[1:], prior=p, device=dev,
            **kw)
    (ctx_c, st_c), (ctx_g, st_g) = ctxs["cpu"], ctxs[device]
    out = dict(init_state_err=max(max_err(a.cpu(), b) for a, b in
                                  zip(st_g[:4], st_c[:4])))
    fz_c = stagei._freeze_stagei_structure(ctx_c, st_c[0], st_c[1])
    fz_own = stagei._freeze_stagei_structure(ctx_g, st_g[0], st_g[1])
    out["candidate_sets_differ"] = int(sum(
        set(a.tolist()) != set(b.tolist()) for a, b in
        zip(fz_own["cand_faces"].cpu(), fz_c["cand_faces"])))
    out.update(check_stagei_step(ctx_c, fz_c, ctx_c.lay.pack(*st_c), ctx_g,
                                 device))
    for anneal in (1.0, 0.25):
        step = out[f"anneal {anneal}"]
        errs = "; ".join(
            f"{n} {step[n]['card']:.2e} (CPU {step[n]['cpu']:.2e}, limit "
            f"{step[n]['limit']:.2e}, card vs CPU {step[n]['card_vs_cpu']:.2e})"
            for n in "rJgB")
        log(f"phase 6a: step at anneal {anneal}: R={step['rows']}, "
            f"D={step['dof']}; against float64: {errs}; CPU "
            f"{step['cpu_s']:.2f} s, card {step['card_s']:.3f} s")
    log(f"phase 6a: init state card vs CPU {out['init_state_err']:.2e}; the "
        f"card's own freeze: {out['candidate_sets_differ']} of {MARKERS} "
        f"markers' candidate sets differ from the CPU's")
    report["stagei step 6a"] = out


def phase_stagei_parity(report, model_c, prior_c, model_g, prior_g,
                        device="cuda"):
    """Phase 6b: the full-width model at STAGEI_PARITY_FRAMES frames and
    maxiter STAGEI_PARITY_MAXITER solved on the CPU and on the card. The
    card's mean data error within STAGEI_MEAN_MM of the CPU's and of the
    JAX package's (JAX_PARITY_ERR_MM), its latents within STAGEI_LATENT_MM
    of the CPU's, or, where the JAX solve of this problem moves more under
    1e-7 m of observation noise (JAX_PARITY_ERR_SPREAD_MM,
    JAX_PARITY_LAT_SPREAD_MM), within FLOOR_FACTOR x that spread. A latent
    limit of several mm cannot tell a faulty card solve from a faithful
    one; 6a holds the card's arithmetic."""
    import torch
    world = stagei_world(0, STAGEI_PARITY_FRAMES, model_c, prior_c)
    threads = torch.get_num_threads()
    torch.set_num_threads(CPU_THREADS_PER_SOLVE)
    try:
        t0 = time.perf_counter()
        res_c = stagei_solve(world, model_c, prior_c, "cpu",
                             STAGEI_PARITY_MAXITER)
        t_cpu = time.perf_counter() - t0
    finally:
        torch.set_num_threads(threads)
    t0 = time.perf_counter()
    res_g = stagei_solve(world, model_g, prior_g, device,
                         STAGEI_PARITY_MAXITER)
    t_card = time.perf_counter() - t0
    lat_c = res_c.markers_latent.numpy()
    lat_g = res_g.markers_latent.cpu().numpy()
    out = dict(
        frames=STAGEI_PARITY_FRAMES, maxiter=STAGEI_PARITY_MAXITER,
        err_cpu_mm=res_c.errs["data_mean_m"] * 1e3,
        err_card_mm=res_g.errs["data_mean_m"] * 1e3,
        d_lat_mm=float(np.abs(lat_g - lat_c).max()) * 1e3,
        d_lat_mean_mm=float(np.linalg.norm(lat_g - lat_c, axis=-1).mean())
        * 1e3,
        iterations_cpu=res_c.iterations, iterations_card=res_g.iterations,
        cpu_s=t_cpu, card_s=t_card,
        err_limit_mm=max(STAGEI_MEAN_MM,
                         FLOOR_FACTOR * JAX_PARITY_ERR_SPREAD_MM),
        lat_limit_mm=max(STAGEI_LATENT_MM,
                         FLOOR_FACTOR * JAX_PARITY_LAT_SPREAD_MM))
    out["d_err_mm"] = abs(out["err_card_mm"] - out["err_cpu_mm"])
    out["d_err_jax_mm"] = abs(out["err_card_mm"] - JAX_PARITY_ERR_MM)
    out["gate"] = ", ".join(
        "fixed bar" if lim == bar else "JAX spread" for lim, bar in (
            (out["err_limit_mm"], STAGEI_MEAN_MM),
            (out["lat_limit_mm"], STAGEI_LATENT_MM)))
    log(f"phase 6b: F={STAGEI_PARITY_FRAMES}, maxiter "
        f"{STAGEI_PARITY_MAXITER}: mean data err cpu {out['err_cpu_mm']:.4f} "
        f"mm ({t_cpu:.1f} s, iterations {res_c.iterations}), card "
        f"{out['err_card_mm']:.4f} mm ({t_card:.1f} s, {res_g.iterations}); "
        f"difference {out['d_err_mm']:.4f} mm, from JAX's "
        f"{JAX_PARITY_ERR_MM:.4f} mm {out['d_err_jax_mm']:.4f} mm (limit "
        f"{out['err_limit_mm']:.4f}), latents {out['d_lat_mm']:.4f} mm max, "
        f"{out['d_lat_mean_mm']:.4f} mm mean (limit "
        f"{out['lat_limit_mm']:.4f}); gate (data error, latents): "
        f"{out['gate']}")
    report["stagei parity 6b"] = out
    assert np.isfinite(out["err_card_mm"]) and np.isfinite(out["err_cpu_mm"])
    assert out["d_err_mm"] <= out["err_limit_mm"], out
    assert out["d_err_jax_mm"] <= out["err_limit_mm"], out
    assert out["d_lat_mm"] <= out["lat_limit_mm"], out


def phase_stagei_slice(report, model, prior, world, device="cuda"):
    """Phase 6c: the tools/bench_stagei.py protocol on the card, one warm-up
    and the median of TIMED_SOLVES solves: seconds a subject, the mean data
    error held to the JAX package's on the same problem (JAX_STAGEI_ERR_MM,
    within max(STAGEI_REF_MM, FLOOR_FACTOR x JAX_STAGEI_SPREAD_MM)), the
    recovery metrics, host syncs, iterations per annealing step and peak
    device memory. Returns the result."""
    import torch
    t0 = time.perf_counter()
    stagei_solve(world, model, prior, device)
    warm = time.perf_counter() - t0
    times = []
    for i in range(TIMED_SOLVES):
        if i == TIMED_SOLVES - 1:
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = stagei_solve(world, model, prior, device)
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    err_mm = res.errs["data_mean_m"] * 1e3
    out = dict(frames=STAGEI_FRAMES, markers=MARKERS,
               verts=int(model.v_template.shape[0]), pose_dof=model.pose_dof,
               dof=16 + 3 * MARKERS + STAGEI_FRAMES * (model.pose_dof + 3),
               warmup_s=warm, solve_s=times,
               seconds_per_subject=statistics.median(times),
               mean_data_err_mm=err_mm, jax_err_mm=JAX_STAGEI_ERR_MM,
               iterations=res.iterations, host_syncs=res.host_syncs,
               peak_mem_gib=peak / 2**30, start_mem_gib=base / 2**30,
               **stagei_recovery(model, world, res))
    out["ref_limit_mm"] = max(STAGEI_REF_MM,
                              FLOOR_FACTOR * JAX_STAGEI_SPREAD_MM)
    log(f"phase 6c: stage i, {out['verts']} verts, {MARKERS} markers, "
        f"{STAGEI_FRAMES} frames, D={out['dof']}: "
        f"{out['seconds_per_subject']:.3f} s a subject (median of "
        f"{[round(t, 3) for t in times]}, warm-up {warm:.2f} s); mean data "
        f"err {err_mm:.4f} mm (JAX on the CPU {JAX_STAGEI_ERR_MM:.4f} mm, "
        f"limit {out['ref_limit_mm']:.4f}); betas rms {out['betas_rms']:.5f}, "
        f"latent err {out['latent_err_mm']:.3f} mm, vid snap "
        f"{out['vid_snap_hit_rate']:.3f} / {out['vid_snap_dist_mm']:.3f} mm, "
        f"v2v {out['v2v_mm']:.3f} mm; iterations {res.iterations}, host "
        f"syncs {res.host_syncs}, peak device memory "
        f"{peak / 2**30:.4f} GiB ({base / 2**30:.4f} as it began)")
    report["stagei slice 6c"] = out
    assert torch.isfinite(res.markers_latent).all()
    assert res.markers_sim.shape == (STAGEI_FRAMES, MARKERS, 3)
    assert torch.isfinite(res.markers_sim).all()
    assert abs(err_mm - JAX_STAGEI_ERR_MM) <= out["ref_limit_mm"], out
    return res


def phase_stagei_batched(report, model, prior, model_c, prior_c, world0,
                         res0, device="cuda"):
    """Phase 6d: STAGEI_SUBJECTS subjects of the 6c protocol (seeds 0, 1,
    ...: one layout, their own shape and motion) in one batched solve:
    seconds a subject and peak memory. Each subject's mean data error
    within max(STAGEI_REF_MM, FLOOR_FACTOR x JAX_BATCHED_SPREAD_MM[s]) of
    the JAX package's batched solve of the same subjects
    (JAX_BATCHED_ERR_MM[s]). tests/test_pipeline.py:231's bar, below
    max(2 x the subject's single solve, 4 mm), is read for every subject
    beside the JAX package's own reading; it reads one chaotic draw a
    subject (see JAX_BATCHED_ERR_MM)."""
    import torch
    from moshpp_torch.pipeline.stagei import mosh_stagei_solve_batched
    worlds = [world0] + [stagei_world(s, STAGEI_FRAMES, model_c, prior_c)
                         for s in range(1, STAGEI_SUBJECTS)]
    t0 = time.perf_counter()
    singles = [res0] + [stagei_solve(w, model, prior, device)
                        for w in worlds[1:]]
    t_singles = time.perf_counter() - t0
    args, kw = stagei_args(world0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = mosh_stagei_solve_batched(
        model, np.stack([w["obs"] for w in worlds]),
        np.stack([w["mask"] for w in worlds]), *args, prior=prior,
        device=device, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    errs = [r.errs["data_mean_m"] * 1e3 for r in res]
    single_errs = [r.errs["data_mean_m"] * 1e3 for r in singles]
    bar = lambda b, one: b < max(2.0 * one, 4.0)
    limits = [max(STAGEI_REF_MM, FLOOR_FACTOR * sp)
              for sp in JAX_BATCHED_SPREAD_MM]
    out = dict(subjects=STAGEI_SUBJECTS, batched_s=dt,
               seconds_per_subject=dt / STAGEI_SUBJECTS,
               singles_s_per_subject=t_singles / (STAGEI_SUBJECTS - 1),
               mean_data_err_mm=errs, single_err_mm=single_errs,
               jax_batched_err_mm=JAX_BATCHED_ERR_MM,
               jax_single_err_mm=JAX_SINGLE_ERR_MM,
               d_jax_mm=[abs(e - j) for e, j in zip(errs, JAX_BATCHED_ERR_MM)],
               limit_mm=limits,
               subject_bar_met=[bar(e, e1) for e, e1 in zip(errs, single_errs)],
               jax_subject_bar_met=[bar(e, e1) for e, e1 in
                                    zip(JAX_BATCHED_ERR_MM, JAX_SINGLE_ERR_MM)],
               iterations=[r.iterations for r in res],
               host_syncs=res[0].host_syncs, peak_mem_gib=peak / 2**30,
               recovery=[stagei_recovery(model, w, r)
                         for w, r in zip(worlds, res)])
    r4 = lambda v: [round(e, 4) for e in v]
    log(f"phase 6d: {STAGEI_SUBJECTS} subjects batched in {dt:.2f} s "
        f"({out['seconds_per_subject']:.3f} s a subject; single solves "
        f"{out['singles_s_per_subject']:.3f} s a subject), peak device memory "
        f"{peak / 2**30:.4f} GiB, {res[0].host_syncs} host syncs; mean data "
        f"err batched {r4(errs)} mm, JAX batched {r4(JAX_BATCHED_ERR_MM)}, "
        f"difference {r4(out['d_jax_mm'])} (limits {r4(limits)}); single "
        f"{r4(single_errs)} mm (JAX {r4(JAX_SINGLE_ERR_MM)}); the bar below "
        f"max(2 x single, 4 mm) met by {sum(out['subject_bar_met'])} of "
        f"{STAGEI_SUBJECTS} subjects (JAX: "
        f"{sum(out['jax_subject_bar_met'])})")
    report["stagei batched 6d"] = out
    for r in res:
        assert torch.isfinite(r.markers_latent).all()
        assert torch.isfinite(r.markers_sim).all()
    for s, (d, lim) in enumerate(zip(out["d_jax_mm"], limits)):
        assert d <= lim, (f"subject {s}", out)


def phase_stagei_chain(report, model, prior, world, res, device="cuda"):
    """Phase 6e: 6c's betas and latent markers into
    `prepare_stageii_problem`, then stage ii at the bench protocol (F=FRAMES,
    the bench problem's motion generator, rng 1) of the same subject, whose
    observations come from its true shape and latents: the mean marker
    error, v2v body/hands against the true bodies, frames/s and each
    kernel's launches; every kernel of the E=0 path must launch."""
    import torch
    from moshpp_torch import kernels
    from moshpp_torch.models import lbs_forward
    from moshpp_torch.pipeline import stageii

    opts = stageii.StageIIOptions(maxiter=100, smoothing_sweeps=2,
                                  optimize_fingers=True)
    rng = np.random.default_rng(1)
    P = model.pose_dof
    poses = np.zeros((FRAMES, P), np.float32)
    poses[0] = rng.normal(size=P) * 0.15
    for t in range(1, FRAMES):
        poses[t] = 0.97 * poses[t - 1] + rng.normal(size=P).astype(
            np.float32) * 0.02
    trans = np.cumsum(rng.normal(size=(FRAMES, 3)) * 0.005, 0).astype(
        np.float32)
    x_true = torch.as_tensor(np.concatenate([trans, poses], 1), device=device)
    truth = stageii.prepare_stageii_problem(model, world["betas"],
                                            world["latents"], opts,
                                            device=device)
    obs = stageii.simulate_markers(truth, opts, x_true)
    mask = torch.ones((FRAMES, MARKERS), dtype=torch.bool, device=device)
    prob = stageii.prepare_stageii_problem(model, res.betas,
                                           res.markers_latent, opts,
                                           device=device)

    def solve():
        out = stageii.mosh_stageii_solve(prob, opts, obs, mask, prior=prior,
                                         model_type="smplh", device=device)
        torch.cuda.synchronize()
        return out

    solve()
    kernels.COUNTS.reset()
    t0 = time.perf_counter()
    sol = solve()
    dt = time.perf_counter() - t0
    launches = dict(kernels.COUNTS.launches)
    plain_cuda = dict(kernels.COUNTS.plain_cuda)
    sub = np.linspace(0, FRAMES - 1, 64).astype(int)
    v_true = lbs_forward(model, x_true[sub, 3:], torch.as_tensor(
        world["betas"], device=device), x_true[sub, :3])
    v_sol = lbs_forward(model, sol.pose[sub], res.betas, sol.trans[sub])
    v2v = torch.linalg.vector_norm(v_sol - v_true, dim=-1)
    body = torch.argmax(model.weights, dim=1) < 1 + model.info.body_pose_dof // 3
    out = dict(frames=FRAMES, solve_s=dt, frames_per_s=FRAMES / dt,
               mean_marker_err_mm=float(sol.data_err.mean()) * 1e3,
               v2v_body_mm=float(v2v[:, body].mean()) * 1e3,
               v2v_hands_mm=float(v2v[:, ~body].mean()) * 1e3,
               host_syncs=sol.host_syncs, launches=launches,
               plain_cuda=plain_cuda)
    log(f"phase 6e: stage i's betas and latents into stage ii, F={FRAMES}: "
        f"{dt:.3f} s ({out['frames_per_s']:.1f} frames/s); mean marker err "
        f"{out['mean_marker_err_mm']:.4f} mm; v2v body "
        f"{out['v2v_body_mm']:.4f} mm, hands {out['v2v_hands_mm']:.4f} mm; "
        f"host syncs {sol.host_syncs}")
    log(f"  launches in the chained solve: {launches}")
    report["stagei chain 6e"] = out
    assert torch.isfinite(sol.markers_sim).all() and torch.isfinite(sol.pose).all()
    assert sol.markers_sim.shape == (FRAMES, MARKERS, 3)
    for name in TPU_KERNELS:
        assert launches.get(name, 0) > 0, f"{name} never launched in 6e"
    assert sum(plain_cuda.values()) == 0, plain_cuda
    return launches


def phase_stagei(report, device="cuda"):
    """Phase 6, stage i: 6a the step, 6b parity, 6c the slice, 6d batched,
    6e the chain into stage ii. Returns 6e's launches."""
    import torch
    model_c, prior_c = stagei_model("cpu")
    model_g = model_c.to(device)
    prior_g = prior_on(dict(prior=prior_c), device)
    world = stagei_world(0, STAGEI_FRAMES, model_c, prior_c)
    t0 = time.perf_counter()
    phase_stagei_step(report, model_c, prior_c, model_g, prior_g, world,
                      device)
    log(f"phase 6a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_stagei_parity(report, model_c, prior_c, model_g, prior_g, device)
    log(f"phase 6b: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = phase_stagei_slice(report, model_g, prior_g, world, device)
    log(f"phase 6c: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_stagei_batched(report, model_g, prior_g, model_c, prior_c, world,
                         res, device)
    log(f"phase 6d: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches = phase_stagei_chain(report, model_g, prior_g, world, res,
                                  device)
    log(f"phase 6e: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return launches


def main():
    import torch
    t_main = time.perf_counter()

    # ---- phase 0: the card ----------------------------------------------------
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "false); this script runs only on the card")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, REPO)
    from moshpp_torch import kernels

    log(f"phase 0: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, nvcc {kernels.nvcc_path()}; TF32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn "
        f"{torch.backends.cudnn.allow_tf32}")

    # ---- phase 1: build -------------------------------------------------------
    t0 = time.perf_counter()
    _, info = kernels.library()
    log(f"phase 1: kernels {'built' if info.built else 'loaded'} in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {info.seconds:.1f} s) -> "
        f"{os.path.relpath(info.path, REPO)}")
    for line in info.log.splitlines():
        m = re.search(r"(fk_smalls|marker_rows|dogleg_direction|extras_tangent"
                      r"|extras_cols)_kernel(?:I((?:Lb\dE)+)E)?", line)
        if "Compiling entry" in line and m:  # from the mangled name
            flags = zip(TEMPLATE_FLAGS.get(m.group(1), ()),
                        re.findall(r"Lb(\d)E", m.group(2) or ""))
            args = ", ".join(f"{k}={v}" for k, v in flags)
            log(f"  {m.group(1)}" + (f"<{args}>" if args else ""))
        elif "registers" in line or "spill" in line:
            log("    " + line.strip())

    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": info.seconds}
    records = {}
    t0 = time.perf_counter()
    bp = bench_problem(FRAMES, "cuda")
    log(f"problem: {bp['model'].v_template.shape[0]} verts, J="
        f"{bp['model'].num_joints}, P={bp['model'].pose_dof}, "
        f"M={MARKERS}, F={FRAMES} ({time.perf_counter() - t0:.1f} s)")
    check_marker_kernels(bp, records, "2")
    check_direction(bp, records)
    torch.cuda.empty_cache()
    kept = phase_parity(report, "3", (
        ("reference parity problem", parity_problem, 64, False),
        ("bench problem", bench_problem, PARITY_FRAMES, True)))
    launches = phase_slice(bp, report, "4", TPU_KERNELS)
    del bp
    torch.cuda.empty_cache()

    # ---- the DMPL path: phases 2b-4b -----------------------------------------
    t0 = time.perf_counter()
    dp = dmpl_problem(FRAMES, "cuda")
    log(f"DMPL problem: E={dp['prob'].tables.n_extra}, D="
        f"{dp['prob'].tables.dof}, F={FRAMES} "
        f"({time.perf_counter() - t0:.1f} s)")
    check_marker_kernels(dp, records, "2b")
    check_direction(dp, records, "@D125")
    torch.cuda.empty_cache()
    kept.update(phase_parity(report, "3b", (
        ("DMPL problem", dmpl_problem, PARITY_FRAMES, True),)))
    launches_ext = phase_slice(dp, report, "4b",
                               [*EXT_KERNELS, "dogleg_direction"])
    del dp
    torch.cuda.empty_cache()

    # ---- the SMPL-X face path: phases 2c-4c ----------------------------------
    t0 = time.perf_counter()
    fp = face_problem(FRAMES, "cuda")
    log(f"face problem: SMPL-X, {fp['model'].v_template.shape[0]} verts, "
        f"E={fp['prob'].tables.n_extra}, D={fp['prob'].tables.dof}, "
        f"F={FRAMES} ({time.perf_counter() - t0:.1f} s)")
    check_tiled_kernels(fp, records, "2c")
    check_direction(fp, records, "@D206")
    torch.cuda.empty_cache()
    kept.update(phase_parity(report, "3c", (
        ("face problem", face_problem, PARITY_FRAMES, True),)))
    launches_face = phase_slice(fp, report, "4c",
                                [*TILED_KERNELS, "dogleg_direction"])
    tiled_jac = [n for n in TILED_KERNELS if "<sim" not in n]
    assert len({launches_face[n] for n in tiled_jac}) == 1, launches_face

    # ---- the folded-weights path: phases 2d-4d -------------------------------
    # per problem (the face problem of phase 4c first, while it is built):
    # the folded kernel and pcg_direction at its shapes, then its folded slice
    from moshpp_torch.ops import marker_jac as mj
    launches_fold, pcg_launches = {}, 0
    for label, make in (("face", None), ("bench", bench_problem),
                        ("DMPL", dmpl_problem)):
        p = fp if make is None else make(FRAMES, "cuda")
        fp = None
        route = p["prob"].tables.route
        x0, aux, g, B, pmask = rigid_init_system(p)
        check_fold_kernels(p, records, x0, aux, f"2d ({label})")
        pcg_launches += check_pcg(p, records, g, B, pmask, f"2d ({label})")
        del x0, aux, g, B, pmask
        torch.cuda.empty_cache()
        (fk_jac, rows), (fk_sim, rows_sim) = (mj._names(True, route),
                                              mj._names(False, route))
        fold = mj._names(True, route, True)[1]
        extra_kernels = [mj.TANGENT, mj.COLS] if route == "tiled" else []
        counts = phase_slice(
            dict(p, opts=dataclasses.replace(p["opts"], fold_weights=True)),
            report, f"4d ({label})",
            [fk_jac, fold, fk_sim, rows_sim, *extra_kernels,
             "dogleg_direction"])
        unfolded = report[f"slice {dict(face='4c', bench='4', DMPL='4b')[label]}"]
        folded = report[f"slice 4d ({label})"]
        log(f"phase 4d ({label}): {fold} {counts[fold]} launches, {fk_jac} "
            f"{counts[fk_jac]}, {rows} {counts.get(rows, 0)}; frames/s "
            f"{folded['frames_per_s']:.1f} folded against "
            f"{unfolded['frames_per_s']:.1f} unfolded; peak device memory "
            f"{folded['peak_mem_gib']:.4f} GiB folded against "
            f"{unfolded['peak_mem_gib']:.4f} GiB unfolded (started at "
            f"{folded['start_mem_gib']:.4f} / {unfolded['start_mem_gib']:.4f})")
        assert counts[fold] == counts[fk_jac], (fold, counts)
        for name in extra_kernels:
            assert counts[name] == counts[fk_jac], (name, counts)
        assert counts.get(rows, 0) == 0, (rows, counts)
        launches_fold[fold] = counts[fold]
        del p
        torch.cuda.empty_cache()
    phase_fold_parity(report, "3d", kept)
    log(f"phases 0-4d: {time.perf_counter() - t_main:.1f} s")

    # ---- the other families: phases 2e-4g; long sequences: phase 5 -------
    launches_family = {}
    for label, make, letter in FAMILIES:
        t0 = time.perf_counter()
        launches_family[label] = phase_family(label, make, letter, report,
                                              records)
        log(f"phases 2{letter}-4{letter} ({label}): "
            f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_long(report)
    log(f"phase 5: {time.perf_counter() - t0:.1f} s")

    # ---- stage i: phase 6 ----------------------------------------------------
    t0 = time.perf_counter()
    phase_stagei(report)
    log(f"phase 6: {time.perf_counter() - t0:.1f} s")

    kern = []
    records["pcg_direction"] = records["pcg_direction@D117"]
    tables = [(TPU_KERNELS, launches, ""), (EXT_KERNELS, launches_ext, ""),
              (TILED_KERNELS, launches_face, ""),
              (FOLD_KERNELS, launches_fold, ""),
              (PCG_KERNEL, {"pcg_direction": pcg_launches}, "")]
    tables += [(TPU_KERNELS, launches_family[label], f"@{label}")
               for label, _, _ in FAMILIES]
    for table, counts, suffix in tables:
        for name, (src, tpu) in table.items():
            r = records[name + suffix]
            kern.append({"name": name + suffix, "route": "cuda",
                         "source": src, "replaces": tpu,
                         "launches": counts[name],
                         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                         "ms_device": r["ms_device"],
                         "plain_ms": r["plain_ms"],
                         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                         "library_ms": r.get("library_ms")})
            if "bucket_ms_device" in r:
                kern[-1]["bucket_ms_device"] = r["bucket_ms_device"]
            if "unfolded_ms" in r:
                kern[-1]["unfolded_ms"] = r["unfolded_ms"]
                kern[-1]["unfolded_ms_device"] = r["unfolded_ms_device"]
            if name == "pcg_direction":
                kern[-1]["note"] = (
                    "no solve calls it: launches are its entry point's, "
                    "pcg_direction_batched, on the three problems' rigid-init "
                    "systems at 24 and 128 iterations (phase 2d); times at "
                    "D=117, 24 iterations")
    report["kernels"] = kern
    report["timings"] = records
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    report["seconds"] = time.perf_counter() - t_main
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"chip_smoke: {report['seconds']:.1f} s")
    print(json.dumps({"kernels": kern}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
