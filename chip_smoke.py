#!/usr/bin/env python
"""Drive the PyTorch port's stage-ii slice on one NVIDIA H100.

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
     one, the direction kernel at D=206 (dogleg_direction@D206), parity at
     F=256, and the F=4096 face slice, which also reports the expressions'
     and the jaw's RMS errors.

Every kernel entry carries its bound: the least time the card could take
for the call, the larger of its bytes (each input read once, each output
written once) over the memory rate and its operations over the float32
and float64 rates (`bound`).

The last three lines of stdout are the kernels JSON (fifteen kernel
entries), the card's name and power limit, and {"ok": true, "device":
{...}}. A fuller record goes to chiprun_out/chip_smoke.json.
"""

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

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
    return float((a - b).abs().max())


def smalls_errors(name, k, p) -> dict:
    """Max abs error of each field of an fk_smalls kernel's output `k`
    against its plain version's `p`, asserted within TOL_SMALLS times the
    largest plain value (at least 1)."""
    import torch
    torch.cuda.synchronize()
    errs = {f: max_err(a, b) for f, a, b in zip(k._fields, k, p)
            if a is not None}
    scale = max(1.0, max(float(b.abs().max()) for b in p if b is not None))
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
    (an FMA is two): ~130 a (frame, joint) for Rodrigues, the tree walk,
    A_tr and the features, ~700 more for dR and the generators; inline
    extras 12 E more, and with the Jacobian their chain sums."""
    J, E = tables.num_joints, tables.n_extra
    per = 130 + (700 if with_jac else 0)
    total = F * J * per
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


def check_marker_kernels(bp, records, phase):
    """The fk_smalls and marker_rows variants of the problem's path (E=0 or
    E-carrying) against their plain versions at its shapes, and their
    times."""
    import torch
    from moshpp_torch.ops import marker_jac as mj

    model, tables = bp["prob"].sub_model, bp["prob"].tables
    theta, trans, extra = mj.kernel_inputs(model, tables, bp["x_true"])
    route = tables.route
    F = theta.shape[0]
    log(f"phase {phase}: theta {tuple(theta.shape)}, M={tables.num_markers}, "
        f"E={tables.n_extra}, D={tables.dof}, featN={tables.feat_n}")
    t_fk = (tables.parents_t, tables.depth_t, tables.jnts, tables.trel)
    t_ext = (extra, tables.djnt, tables.dtrel, tables.ancmask) if extra is not None else ()

    sms = {}
    for with_jac in (True, False):
        name = mj._names(with_jac, route)[0]
        k = mj.fk_smalls(theta, tables, with_jac, extra)
        p = mj.fk_smalls_plain(theta, tables, with_jac, extra)
        errs = smalls_errors(name, k, p)
        records[name] = dict(
            max_abs_err=max(errs.values()),
            **timed(lambda: mj.fk_smalls(theta, tables, with_jac, extra),
                    lambda: mj.fk_smalls_plain(theta, tables, with_jac,
                                               extra)),
            **bound((theta, *t_fk, *t_ext), k,
                    fk_flops(tables, F, with_jac, route)))
        if "datr" in errs:
            records[name]["datr_max_abs_err"] = errs["datr"]
        sms[with_jac] = k

    for with_jac in (True, False):
        name, sm = mj._names(with_jac, route)[1], sms[with_jac]
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
    t_fk = (tables.parents_t, tables.depth_t, tables.jnts, tables.trel)

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
                    fk_flops(tables, F, with_jac, "tiled")))
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
        **bound((sm.q, sm.grot, tables.dtrel, tables.djnt, tables.ancmask),
                (datr_k,), F * E * chain))
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
        **bound((datr_k, uv_k, w3, dv), (jm_k[..., Dp:],),
                F * E * (6 * nnz + M * 3 * 36)))
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


def check_direction(bp, records, suffix=""):
    """The direction kernel against its plain version at the problem's D:
    on B from the real assembly at the rigid init and on synthetic systems
    of the same shape. Records its entries under `dogleg_direction<suffix>`
    ("" on the E=0 path, "@D125" on the DMPL path, "@D206" on the face
    path)."""
    import torch
    from moshpp_torch.pipeline import stageii
    from moshpp_torch.solver import gauss_newton, pcg

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
    D = g.shape[1]
    _, step2 = stageii._param_masks(prob.sub_model, opts, bp["model_type"],
                                    x0.device)
    pmask = step2.expand_as(g).contiguous()
    g = (g * pmask).contiguous()
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


def solve_both(bp, opts, floor: bool):
    """Solve one problem on the CPU (plain versions) and on the card
    (kernels); the mean marker errors and the largest difference of any
    fitted marker coordinate (wander), in mm. With `floor`, also the largest
    wander between the CPU solve and CPU solves whose observations differ by
    1e-7 m (FLOOR_SEEDS): the solve's own sensitivity to rounding."""
    import torch
    from moshpp_torch.pipeline import stageii

    prob_c = bp["prob"]
    prob_g = stageii.problem_from_arrays(
        prob_c.sub_model, prob_c.indices.stacked.numpy(),
        prob_c.coeffs.numpy(), prob_c.betas.numpy(), opts, device="cuda")
    prior_g = dataclasses.replace(
        bp["prior"], **{f.name: getattr(bp["prior"], f.name).cuda()
                        for f in dataclasses.fields(bp["prior"])})

    def cpu_solve(obs):
        return stageii.mosh_stageii_solve(prob_c, opts, obs, bp["mask"],
                                          prior=bp["prior"],
                                          model_type=bp["model_type"],
                                          device="cpu")

    t0 = time.perf_counter()
    res_c = cpu_solve(bp["obs"])
    t_cpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_g = stageii.mosh_stageii_solve(prob_g, opts, bp["obs"].cuda(),
                                       bp["mask"].cuda(), prior=prior_g,
                                       model_type=bp["model_type"],
                                       device="cuda")
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    wander = lambda a, b: float((a.cpu() - b.cpu()).abs().max()) * 1e3
    out = dict(err_cpu_mm=float(res_c.data_err.mean()) * 1e3,
               err_card_mm=float(res_g.data_err.mean()) * 1e3,
               max_wander_mm=wander(res_g.markers_sim, res_c.markers_sim),
               cpu_s=t_cpu, card_s=t_gpu)
    if floor:
        floors = []
        for seed in FLOOR_SEEDS:
            gen = torch.Generator().manual_seed(seed)
            noise = 1e-7 * torch.randn(bp["obs"].shape, generator=gen)
            res_n = cpu_solve(bp["obs"] + noise)
            floors.append(wander(res_n.markers_sim, res_c.markers_sim))
        out["cpu_floor_wanders_mm"] = floors
        out["cpu_floor_wander_mm"] = max(floors)
    assert np.isfinite(out["err_cpu_mm"]) and np.isfinite(out["err_card_mm"])
    return out


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
    polish through PCG on both sides."""
    for name, make, frames, floor_gate in problems:
        bp = make(frames, "cpu")
        polish = dict(polish_solver="pcg") if floor_gate else {}
        r = solve_both(bp, dataclasses.replace(bp["opts"], **polish),
                       floor=floor_gate)
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
            kernels.COUNTS.reset()     # counts of exactly one main-path solve
        t0 = time.perf_counter()
        res = solve()
        times.append(time.perf_counter() - t0)
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
    v2v_hands = float(v2v[:, ~body_vert].mean()) * 1e3
    fps = FRAMES / dt
    out = dict(frames=FRAMES, solve_s=times, median_s=dt, frames_per_s=fps,
               mean_marker_err_mm=err_mm, v2v_body_mm=v2v_body,
               v2v_hands_mm=v2v_hands, host_syncs=res.host_syncs,
               launches=launches, plain_cuda=plain_cuda)
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
    log(f"phase {phase}: F={FRAMES} solve {dt:.3f} s median of "
        f"{[round(t, 3) for t in times]} -> {fps:.1f} frames/s; mean marker "
        f"err {err_mm:.4f} mm; v2v body {v2v_body:.4f} mm, hands "
        f"{v2v_hands:.4f} mm{dmpl}; host syncs per solve {res.host_syncs}")
    log(f"  launches in one solve: {launches}; plain versions on CUDA: "
        f"{plain_cuda}")
    report[f"slice {phase}"] = out
    assert torch.isfinite(res.markers_sim).all() and torch.isfinite(res.pose).all()
    assert res.markers_sim.shape == (FRAMES, MARKERS, 3)
    assert res.extra.shape == (FRAMES, E) and torch.isfinite(res.extra).all()
    for name in names:
        assert launches.get(name, 0) > 0, f"{name} never launched in the solve"
    assert sum(plain_cuda.values()) == 0, plain_cuda
    assert err_mm <= MAX_MEAN_ERR_MM, err_mm
    return launches


def main():
    import torch

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
                      r"|extras_cols)_kernel(?:ILb(\d)ELb(\d)ELb(\d)E)?", line)
        if "Compiling entry" in line and m:  # from the mangled name
            log(f"  {m.group(1)}" + (
                f"<jac={m.group(2)}, ext={m.group(3)}, tiled={m.group(4)}>"
                if m.group(2) else ""))
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
    phase_parity(report, "3", (
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
    phase_parity(report, "3b", (
        ("DMPL problem", dmpl_problem, PARITY_FRAMES, True),))
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
    phase_parity(report, "3c", (
        ("face problem", face_problem, PARITY_FRAMES, True),))
    launches_face = phase_slice(fp, report, "4c",
                                [*TILED_KERNELS, "dogleg_direction"])

    kern = []
    for table, counts in ((TPU_KERNELS, launches), (EXT_KERNELS, launches_ext),
                          (TILED_KERNELS, launches_face)):
        for name, (src, tpu) in table.items():
            r = records[name]
            kern.append({"name": name, "route": "cuda", "source": src,
                         "replaces": tpu, "launches": counts[name],
                         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                         "ms_device": r["ms_device"],
                         "plain_ms": r["plain_ms"],
                         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                         "library_ms": r.get("library_ms")})
    report["kernels"] = kern
    report["timings"] = records
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kern}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
