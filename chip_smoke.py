#!/usr/bin/env python
"""Drive the PyTorch port's stage-ii slice on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each failing loudly (exception, nonzero exit, no ok line):

  0. the card: refuse to run without CUDA; print the card, CUDA, nvcc and
     the TF32 flags (set off);
  1. build the Hopper kernels from moshpp_torch/csrc with nvcc (sm_90a);
  2. hold every kernel against its plain PyTorch version on the card at the
     main-path shapes (full-width SMPL+H, 46 markers, F=4096, D=117), and
     time both; the direction kernel also against the plain version in
     float64 on systems where 24 CG iterations have not converged;
  3. parity: solve the same problems on the CPU (plain versions) and on the
     card (kernels), polish through PCG in both: the reference's
     quality-parity problem at its own size and tolerances, and the bench
     problem at F=256, whose wander is held to the CPU's own floor;
  4. the slice: `mosh_stageii_solve` at the bench.py protocol (F=4096,
     maxiter=100, two smoothing sweeps, fingers free): one warm-up, the
     median of 3 timed solves, accuracy, host syncs, and each kernel's
     launch count from one solve.

The last three lines of stdout are the kernels JSON, the card's name and
power limit, and {"ok": true, "device": {...}}. A fuller record goes to
chiprun_out/chip_smoke.json.
"""

import dataclasses
import json
import os
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
# multiple of the float32 plain version's own distance from float64
TOL_DIR_VS_F64 = 4.0
# parity (phase 3), the reference's quality-parity bar and settings
PARITY_MEAN_MM, PARITY_WANDER_MM = 0.02, 0.6
FLOOR_FACTOR = 1.5     # bench-problem wander limit: times the CPU's floor
PARITY_OPTS = dict(polish_solver="pcg", e_3_polish=1e-8, e_3_anneal=1e-4,
                   cg_iters=48, cg_iters_polish=256, maxiter=300)
MAX_MEAN_ERR_MM = 1.0

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


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, n=5):
    """Mean device time of `fn` over n runs after one warm-up (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def synthetic_problem(frames, device, opts, *, num_verts, dof_per_hand,
                      model_seed, prior_components, prior_seed, beta_scale,
                      pose0_scale):
    """A synthetic SMPL+H stage-ii problem with 46 markers, smooth random
    motion and a GMM prior on the 63 body dofs; numpy draws in the order of
    bench.py and __graft_entry__._tiny_problem."""
    import torch
    from moshpp_torch.models import make_synthetic_model
    from moshpp_torch.ops.surface import vertex_normals
    from moshpp_torch.pipeline.stageii import (prepare_stageii_problem,
                                               simulate_markers)
    from moshpp_torch.priors.gmm import make_gmm_prior

    rng = np.random.default_rng(0)
    model = make_synthetic_model("smplh", num_verts=num_verts, seed=model_seed,
                                 dof_per_hand=dof_per_hand, device=device)
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
    prob = prepare_stageii_problem(model, betas, latents, opts, device=device)
    x_true = torch.as_tensor(np.concatenate([trans, poses], 1), device=device)
    obs = simulate_markers(prob, opts, x_true)
    mask = torch.ones((frames, MARKERS), dtype=torch.bool, device=device)
    return dict(model=model, prior=prior, betas=bt, opts=opts, prob=prob,
                x_true=x_true, obs=obs, mask=mask)


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


def parity_problem(frames, device):
    """The reference's quality-parity problem (__graft_entry__.py
    dryrun_multichip: _tiny_problem(num_verts=600, markers=46,
    smooth_motion=True), at its tight tolerances)."""
    from moshpp_torch.pipeline.stageii import StageIIOptions
    return synthetic_problem(
        frames, device, StageIIOptions(smoothing_sweeps=1, **PARITY_OPTS),
        num_verts=600, dof_per_hand=6, model_seed=5, prior_components=3,
        prior_seed=2, beta_scale=0.3, pose0_scale=0.12)


def phase_kernels(bp, records):
    """Phase 2: every kernel against its plain version at main-path shapes."""
    import torch
    from moshpp_torch.ops import marker_jac as mj
    from moshpp_torch.pipeline import stageii
    from moshpp_torch.solver import gauss_newton, pcg

    prob, model, tables = bp["prob"], bp["prob"].sub_model, bp["prob"].tables
    theta, trans = mj._theta_trans(model, tables, bp["x_true"])
    log(f"phase 2: theta {tuple(theta.shape)}, M={tables.num_markers}, "
        f"D={tables.dof}, featN={tables.feat_n}")

    for with_jac, name in ((True, mj.FK_JAC), (False, mj.FK_SIM)):
        k = mj.fk_smalls(theta, tables, with_jac)
        p = mj.fk_smalls_plain(theta, tables, with_jac)
        torch.cuda.synchronize()
        errs = {f: max_err(a, b) for f, a, b in zip(k._fields, k, p)
                if a is not None}
        scale = max(1.0, max(float(b.abs().max()) for b in p if b is not None))
        log(f"  {name}: max abs err {errs} (scale {scale:.3g})")
        assert max(errs.values()) <= TOL_SMALLS * scale, (name, errs)
        records[name] = dict(
            max_abs_err=max(errs.values()),
            ms=cuda_ms(lambda: mj.fk_smalls(theta, tables, with_jac)),
            plain_ms=cuda_ms(lambda: mj.fk_smalls_plain(theta, tables,
                                                        with_jac)))
        if with_jac:
            sm_jac = k
        else:
            sm_sim = k

    for with_jac, name, sm in ((True, mj.ROWS_JAC, sm_jac),
                               (False, mj.ROWS_SIM, sm_sim)):
        sim_k, jm_k = mj.marker_rows(sm, trans, tables, with_jac)
        sim_p, jm_p = mj.marker_rows_plain(sm, trans, tables, with_jac)
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
        records[name] = dict(
            max_abs_err=e,
            ms=cuda_ms(lambda: mj.marker_rows(sm, trans, tables, with_jac)),
            plain_ms=cuda_ms(lambda: mj.marker_rows_plain(sm, trans, tables,
                                                          with_jac), n=2))
        torch.cuda.empty_cache()

    # the direction kernel on B from the real assembly at the rigid init
    opts = bp["opts"]
    F = bp["obs"].shape[0]
    maskf = bp["mask"].to(torch.float32)
    x0 = stageii.rigid_init(prob, opts, bp["obs"], maskf)
    system = stageii.make_stageii_system(prob, opts, bp["prior"], "smplh")
    n_obs = maskf.sum(1)
    aux = {"markers": bp["obs"], "mask": maskf,
           "wt_data": opts.wt("data") * 46.0 / n_obs.clamp(min=1.0),
           "anneal": torch.ones(F, device=x0.device),
           "wt_pose_scale": torch.full((F,), 10.0, device=x0.device),
           "velo_anchor": torch.zeros_like(x0[:, 3:]),
           "velo_on": torch.zeros(F, device=x0.device)}
    _, g, B = system.system_fn(x0, aux)
    _, step2 = stageii._param_masks(prob.sub_model, opts, "smplh", x0.device)
    pmask = step2.expand_as(g).contiguous()
    g = (g * pmask).contiguous()
    plin = torch.zeros_like(g)
    delta = torch.full((F,), 0.5, device=g.device)

    # (i) synthetic systems of the main-path shape (pcg.direction_test_system:
    # all three dogleg branches, warm starts taken and refused, masked
    # unknowns) at Jacobi-scaled condition ~5, ~1e2 and ~1e3. The kernel is
    # held to the plain version run in float64 on the same inputs, within
    # TOL_DIR_VS_F64 times the float32 plain version's own distance from it:
    # at ~1e2 and ~1e3 CG has not converged after 24 iterations, so a wrong
    # recurrence, preconditioner, warm start or iteration count lands 10x
    # or more farther off (PERF.md). At ~5 CG converges, and the kernel must
    # also meet the elementwise tolerances against the float32 plain version.
    def held_to_f64(tag, out_k, out_p, out_64, elementwise=False):
        """Gate (p, p_gn, pred) of the kernel on the float64 plain run;
        with `elementwise`, also on the float32 plain run. Returns the
        kernel's and the float32 plain version's distances in p."""
        torch.cuda.synchronize()
        for nm, k, p, r in zip(("p", "p_gn", "pred"), out_k, out_p, out_64):
            e_k, e_p = max_err(k.double(), r), max_err(p.double(), r)
            if nm == "p":
                dist = (e_k, e_p)
            line = (f"  dogleg_direction {tag} {nm}: |kernel-f64| {e_k:.3g}, "
                    f"|plain f32-f64| {e_p:.3g}, |f64| max "
                    f"{float(r.abs().max()):.3g}")
            if elementwise:
                rtol, atol = ((TOL_PRED_RTOL, 1e-6) if nm == "pred"
                              else (TOL_DIR_RTOL, TOL_DIR_ATOL))
                bad = int(((k - p).abs() > atol + rtol * p.abs()).sum())
                line += f"; vs plain f32 {bad} of {k.numel()} outside"
                assert bad == 0, ("dogleg_direction", tag, nm)
            log(line)
            assert e_k <= TOL_DIR_VS_F64 * e_p + 1e-6 * float(r.abs().max()), (
                "dogleg_direction", tag, nm)
        return dist

    errs = []
    for cond in (5.0, 1e2, 1e3):
        sys_args = pcg.direction_test_system(F, g.shape[1], cond, seed=1,
                                             device=g.device)
        for iters in (opts.cg_iters, opts.cg_iters_polish):
            e_k, e_p = held_to_f64(
                f"cond ~{cond:g} iters={iters}",
                pcg.dogleg_direction_batched(*sys_args, iters, 1e-8),
                pcg.dogleg_direction_plain(*sys_args, iters, 1e-8),
                pcg.dogleg_direction_plain(*(t.double() for t in sys_args),
                                           iters, 1e-8),
                elementwise=cond == 5.0)
            errs.append(e_k)
            records[f"dogleg_direction cond {cond:g} @{iters}"] = dict(
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
            log(f"  dogleg_direction iters={iters} (real B, {who}): |p| max "
                f"{float(norm.max()):.4g} (radius 0.5), pred vs own step rel "
                f"{rel:.3g}, max cos(g, p) {uphill:.3g}, min pred "
                f"{float(pred.min()):.4g}")
            assert torch.isfinite(p).all() and torch.isfinite(pred).all(), who
            assert float(norm.max()) <= 0.5 * (1 + 1e-5), (who, "radius")
            assert rel <= TOL_PRED_RTOL, (who, "pred", rel)
            assert uphill <= 1e-6 and float(pred.min()) >= -floor, (who, "descent")
        out_64 = pcg.dogleg_direction_plain(*(t.double() for t in args[:5]),
                                            iters, 1e-8)
        held_to_f64(f"iters={iters} (real B)", outs["kernel"], outs["plain"],
                    out_64)
        records[f"dogleg_direction@{iters}"] = dict(
            ms=cuda_ms(lambda: pcg.dogleg_direction_batched(*args)),
            plain_ms=cuda_ms(lambda: pcg.dogleg_direction_plain(*args), n=2))
    records["dogleg_direction"] = dict(
        max_abs_err=max(errs), **records[f"dogleg_direction@{opts.cg_iters}"])


def solve_both(bp, opts, floor: bool):
    """Solve one problem on the CPU (plain versions) and on the card
    (kernels); the mean marker errors and the largest difference of any
    fitted marker coordinate (wander), in mm. With `floor`, also the wander
    between the CPU solve and a second CPU solve whose observations differ
    by 1e-7 m: the solve's own sensitivity to rounding."""
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
                                          model_type="smplh", device="cpu")

    t0 = time.perf_counter()
    res_c = cpu_solve(bp["obs"])
    t_cpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_g = stageii.mosh_stageii_solve(prob_g, opts, bp["obs"].cuda(),
                                       bp["mask"].cuda(), prior=prior_g,
                                       model_type="smplh", device="cuda")
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    wander = lambda a, b: float((a.cpu() - b.cpu()).abs().max()) * 1e3
    out = dict(err_cpu_mm=float(res_c.data_err.mean()) * 1e3,
               err_card_mm=float(res_g.data_err.mean()) * 1e3,
               max_wander_mm=wander(res_g.markers_sim, res_c.markers_sim),
               cpu_s=t_cpu, card_s=t_gpu)
    if floor:
        gen = torch.Generator().manual_seed(7)
        noise = 1e-7 * torch.randn(bp["obs"].shape, generator=gen)
        res_n = cpu_solve(bp["obs"] + noise)
        out["cpu_floor_wander_mm"] = wander(res_n.markers_sim,
                                            res_c.markers_sim)
    assert np.isfinite(out["err_cpu_mm"]) and np.isfinite(out["err_card_mm"])
    return out


def phase_parity(report):
    """Phase 3: the same problems solved on the CPU and on the card.

    Both must meet the mean bar. The reference parity problem runs at the
    reference's own size and settings (F=64, tight tolerances, where the
    JAX package measured 0.1-0.35 mm of wander between two of its own
    solves) and must meet the 0.6 mm wander bar. On the bench problem at
    F=256 that bar does not hold even between two solves of the JAX package
    (PERF.md), so its wander must stay within the larger of 0.6 mm and
    FLOOR_FACTOR times the CPU's own floor measured in the same run (two
    CPU solves 1e-7 m apart in the observations)."""
    for name, make, frames, polish in (
            ("reference parity problem", parity_problem, 64, {}),
            ("bench problem", bench_problem, PARITY_FRAMES,
             dict(polish_solver="pcg"))):
        bp = make(frames, "cpu")
        bench = make is bench_problem
        r = solve_both(bp, dataclasses.replace(bp["opts"], **polish),
                       floor=bench)
        r["wander_limit_mm"] = PARITY_WANDER_MM
        floor = ""
        if bench:
            r["wander_limit_mm"] = max(
                PARITY_WANDER_MM, FLOOR_FACTOR * r["cpu_floor_wander_mm"])
            floor = f", cpu-vs-cpu floor {r['cpu_floor_wander_mm']:.4f} mm"
        log(f"phase 3: {name}, F={frames}: mean marker err cpu "
            f"{r['err_cpu_mm']:.4f} mm, card {r['err_card_mm']:.4f} mm, max "
            f"wander {r['max_wander_mm']:.4f} mm{floor}, limit "
            f"{r['wander_limit_mm']:.4f} mm (cpu {r['cpu_s']:.1f} s, card "
            f"{r['card_s']:.1f} s incl. first calls)")
        report[f"parity: {name}"] = dict(frames=frames, **r)
        assert abs(r["err_cpu_mm"] - r["err_card_mm"]) <= PARITY_MEAN_MM, r
        assert r["max_wander_mm"] <= r["wander_limit_mm"], r


def phase_slice(bp, report):
    """Phase 4: the main path at the bench protocol."""
    import torch
    from moshpp_torch import kernels
    from moshpp_torch.models import lbs_forward
    from moshpp_torch.pipeline import stageii

    def solve():
        out = stageii.mosh_stageii_solve(bp["prob"], bp["opts"], bp["obs"],
                                         bp["mask"], prior=bp["prior"],
                                         model_type="smplh", device="cuda")
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    res = solve()                                          # warm-up
    log(f"phase 4: warm-up solve {time.perf_counter() - t0:.2f} s")
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

    model, betas = bp["model"], bp["betas"]
    sub = np.linspace(0, FRAMES - 1, 64).astype(int)
    v_true = lbs_forward(model, bp["x_true"][sub, 3:], betas,
                         bp["x_true"][sub, :3])
    v_sol = lbs_forward(model, res.pose[sub], betas, res.trans[sub])
    v2v = torch.linalg.vector_norm(v_sol - v_true, dim=-1)
    body_vert = torch.argmax(model.weights, dim=1) < 1 + model.info.body_pose_dof // 3
    v2v_body = float(v2v[:, body_vert].mean()) * 1e3
    v2v_hands = float(v2v[:, ~body_vert].mean()) * 1e3
    fps = FRAMES / dt
    log(f"phase 4: F={FRAMES} solve {dt:.3f} s median of "
        f"{[round(t, 3) for t in times]} -> {fps:.1f} frames/s; mean marker "
        f"err {err_mm:.4f} mm; v2v body {v2v_body:.4f} mm, hands "
        f"{v2v_hands:.4f} mm; host syncs per solve {res.host_syncs}")
    log(f"  launches in one solve: {launches}; plain versions on CUDA: "
        f"{plain_cuda}")
    report["slice"] = dict(frames=FRAMES, solve_s=times, median_s=dt,
                           frames_per_s=fps, mean_marker_err_mm=err_mm,
                           v2v_body_mm=v2v_body, v2v_hands_mm=v2v_hands,
                           host_syncs=res.host_syncs, launches=launches,
                           plain_cuda=plain_cuda)
    assert torch.isfinite(res.markers_sim).all() and torch.isfinite(res.pose).all()
    assert res.markers_sim.shape == (FRAMES, MARKERS, 3)
    for name in TPU_KERNELS:
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
        if "registers" in line or "spill" in line:
            log("  " + line.strip())

    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": info.seconds}
    records = {}
    t0 = time.perf_counter()
    bp = bench_problem(FRAMES, "cuda")
    log(f"problem: {bp['model'].v_template.shape[0]} verts, J="
        f"{bp['model'].num_joints}, P={bp['model'].pose_dof}, "
        f"M={MARKERS}, F={FRAMES} ({time.perf_counter() - t0:.1f} s)")
    phase_kernels(bp, records)
    torch.cuda.empty_cache()
    phase_parity(report)
    launches = phase_slice(bp, report)

    kern = []
    for name, (src, tpu) in TPU_KERNELS.items():
        r = records[name]
        kern.append({"name": name, "route": "cuda", "source": src,
                     "replaces": tpu, "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"]})
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
