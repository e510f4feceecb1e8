"""The port's folded-weights data rows and plain PCG direction against the
JAX package, on the CPU.

(a) `marker_resid_and_wjac` (on CPU tensors: the plain versions of the
    `<jac,..,fold>` marker rows) against the JAX package's
    `_marker_jac_w_kernel`, `_marker_jac_w_kernel_ext` and
    `_marker_jac_w_kernel_tiled` in interpret mode, at E=0 on four families,
    inline at E=4 and 8, tiled at E=20, with a marker at w = 0;
(b) the fold against no fold: the unfolded rows times w, bit for bit where
    the multiply comes last, close on the tiled extra columns;
(c) the batched Gauss-Newton system (f, g, B) with `fold_weights` against
    the JAX `system_fn_batched` with `fold_weights=True` on the Pallas route;
(d) whole folded solves: bit for bit the unfolded solve at E=0 and inline,
    at E=20 (tiled) within the fit bar and the rounding floor of the
    unfolded one.

`pcg_direction_batched`, the other entry point of this slice, is held to
the JAX package in tests/test_torch_pcg.py.

Inputs are made from numpy seeds and handed to both packages.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from moshpp_tpu.models import make_synthetic_model as jax_make_model
from moshpp_tpu.ops.pallas_marker_jac import (
    marker_resid_and_wjac as jax_resid_and_wjac)
from moshpp_tpu.ops.surface import vertex_normals as jax_normals
from moshpp_tpu.pipeline import stageii as jax_stageii
from moshpp_tpu.priors import make_gmm_prior as jax_make_prior

from moshpp_torch import kernels
from moshpp_torch.models import make_synthetic_model
from moshpp_torch.models.body_model import surface_model_from_arrays
from moshpp_torch.ops import marker_jac as mj
from moshpp_torch.pipeline import stageii
from moshpp_torch.priors.gmm import gmm_prior_from_arrays

from test_torch_extras import _marker_problem as extras_problem
from test_torch_face import _marker_problem as face_problem
from test_torch_marker_jac import _problem as family_problem

torch.set_num_threads(1)

_MODEL_FIELDS = ("v_template", "shapedirs", "posedirs", "weights",
                 "joint_template", "joint_shapedirs", "hands_components",
                 "hands_mean", "faces")


# ---- (a), (b): the folded marker rows ------------------------------------------

def _obs_and_weights(F, M, seed=5):
    """Observations and weights as tests/test_pallas_jac.py draws them
    (w in [0.5, 3]), with marker 2 of frame 1 missing (w = 0)."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(F, M, 3)).astype(np.float32)
    w = rng.uniform(0.5, 3.0, size=(F, M)).astype(np.float32)
    w[1, 2] = 0.0
    return obs, w


def _check_against_pallas(jm, jt, tm, tt, x):
    """The port's folded rows against the Pallas kernel's: rw within 3e-5 m
    times the largest weight (the sim tolerance of tests/test_pallas_jac.py),
    jw within 3e-4 of its largest entry; the missing marker's rows exactly
    zero."""
    F, M = x.shape[0], tt.num_markers
    obs, w = _obs_and_weights(F, M)
    rw_r, jw_r = jax_resid_and_wjac(jm, jt, jnp.asarray(x), jnp.asarray(obs),
                                    jnp.asarray(w), interpret=True)
    rw, jw = mj.marker_resid_and_wjac(tm, tt, torch.tensor(x),
                                      torch.tensor(obs), torch.tensor(w))
    assert jw.shape == (F, M, 3, tt.dof)
    np.testing.assert_allclose(rw.numpy(), np.asarray(rw_r),
                               atol=3e-5 * w.max())
    jw_r = np.asarray(jw_r)
    np.testing.assert_allclose(jw.numpy(), jw_r,
                               atol=3e-4 * max(np.abs(jw_r).max(), 1.0))
    assert not rw[1, 2].any() and not jw[1, 2].any()


@pytest.mark.parametrize("family", ["smplh", "smpl", "mano", "smplx"])
def test_resid_and_wjac_matches_pallas(family):
    """(a) E=0: `_marker_jac_w_kernel`."""
    jm, jt, tm, tt, rng = family_problem(family, 7)
    x = (rng.normal(size=(5, 3 + tm.pose_dof)) * 0.4).astype(np.float32)
    _check_against_pallas(jm, jt, tm, tt, x)


@pytest.mark.parametrize("mode,E", [("dmpl", 4), ("dmpl", 8), ("expr", 4),
                                    ("expr", 8), ("expr", 20), ("dmpl", 20)])
def test_resid_and_wjac_extras_match_pallas(mode, E):
    """(a) inline extras (`_marker_jac_w_kernel_ext`) and the tiled route
    (`_marker_jac_w_kernel_tiled`, whose weighted chain factors weight the
    extra columns)."""
    p = (extras_problem if E <= mj.MAX_INLINE_EXTRAS else face_problem)(
        mode, E)
    assert p["tt"].route == ("ext" if E <= mj.MAX_INLINE_EXTRAS else "tiled")
    _check_against_pallas(p["jm"], p["jt"], p["tm"], p["tt"], p["x"])


@pytest.mark.parametrize("route", ["", "ext", "tiled"])
def test_fold_is_unfolded_times_w(route):
    """(b) rw and jw against the unfolded (sim - obs) w and jm w: bit for bit
    at E=0 and inline; on the tiled route bit for bit on the trans and pose
    columns and within 1e-6 of the largest entry on the extra columns (their
    chain factors are weighted before `extras_cols` sums them). The entry
    point counts the folded plain version, never the unfolded one."""
    if route == "":
        _, _, tm, tt, rng = family_problem("smplh", 7)
        x = (rng.normal(size=(5, 3 + tm.pose_dof)) * 0.4).astype(np.float32)
    else:
        p = (extras_problem("dmpl", 8) if route == "ext"
             else face_problem("expr", 20))
        tm, tt, x = p["tm"], p["tt"], p["x"]
    assert tt.route == route
    obs, w = map(torch.tensor, _obs_and_weights(x.shape[0], tt.num_markers))
    rw, jw = mj.marker_resid_and_wjac(tm, tt, torch.tensor(x), obs, w)
    sim, jm = mj.marker_sim_and_jacobian(tm, tt, torch.tensor(x))
    jw_u = jm * w[..., None, None]
    assert torch.equal(rw, (sim - obs) * w[..., None])
    n = tt.dof - (tt.n_extra if route == "tiled" else 0)
    assert torch.equal(jw[..., :n], jw_u[..., :n])
    if route == "tiled":
        assert float(jw_u[..., n:].abs().max()) > 1e-3
        np.testing.assert_allclose(jw[..., n:].numpy(), jw_u[..., n:].numpy(),
                                   rtol=0, atol=1e-6 * float(jw_u.abs().max()))


def test_fold_plain_counts_only_on_cuda():
    """CPU inputs never reach the launchers and leave the plain versions'
    on-CUDA counters at zero."""
    _, _, tm, tt, rng = family_problem("smpl", 5)
    kernels.COUNTS.reset()
    x = torch.tensor((rng.normal(size=(3, 3 + tm.pose_dof)) * 0.3)
                     .astype(np.float32))
    obs, w = map(torch.tensor, _obs_and_weights(3, 5))
    mj.marker_resid_and_wjac(tm, tt, x, obs, w)
    assert not kernels.COUNTS.launches and not kernels.COUNTS.plain_cuda


# ---- (c): the system with fold_weights -----------------------------------------

SYSTEM_CASES = {
    # model type, JAX/port option fields, shape dirs
    "smplh": ("smplh", {}, 16),
    "dmpl8": ("smplh", dict(optimize_dynamics=True, num_dmpls=8), 24),
    "expr20": ("smplx", dict(optimize_face=True, num_expressions=20,
                             expr_start=16), 36),
}


def _system_pair(case):
    """A 300-vertex problem with 10 markers in both packages: the JAX one
    with `fold_weights` on the Pallas route, the port's from its frozen
    fields."""
    model_type, extra_opts, n_dirs = SYSTEM_CASES[case]
    rng = np.random.default_rng(3)
    jmodel = jax_make_model(model_type, num_verts=300, seed=3,
                            dof_per_hand=6, num_shape_dirs=n_dirs)
    jopts = jax_stageii.StageIIOptions(optimize_fingers=True,
                                       jac_backend="pallas",
                                       fold_weights=True, **extra_opts)
    betas = (rng.normal(size=16) * 0.3).astype(np.float32)
    can_v = np.asarray(jmodel.v_template) + np.einsum(
        "vcb,b->vc", np.asarray(jmodel.shapedirs)[..., :16], betas)
    vn = np.asarray(jax_normals(jnp.asarray(can_v), jmodel.faces))
    vids = rng.choice(can_v.shape[0], 10, replace=False)
    latents = can_v[vids] + vn[vids] * 0.0095
    jp = jax_stageii.prepare_stageii_problem(jmodel, betas, latents,
                                             opts=jopts)
    jprior = jax_make_prior(dim=63, num_components=3, seed=0, scale=0.4)
    sub = jp.sub_model
    model = surface_model_from_arrays(
        {f: np.asarray(getattr(sub, f)) for f in _MODEL_FIELDS},
        sub.model_type, sub.parents, sub.dof_per_hand,
        num_betas=sub.num_betas, skin_k=sub.skin_k, device="cpu")
    opts = stageii.StageIIOptions(optimize_fingers=True, fold_weights=True,
                                  **extra_opts)
    frame_idx = np.stack([np.asarray(c) for c in
                          (jp.frame_c0, jp.frame_c1, jp.frame_c2)], axis=1)
    prob = stageii.problem_from_arrays(model, frame_idx, np.asarray(jp.coeffs),
                                       np.asarray(jp.betas), opts,
                                       device="cpu")
    prior = gmm_prior_from_arrays(np.asarray(jprior.means),
                                  np.asarray(jprior.chols),
                                  np.asarray(jprior.sqrt_neg_log_w),
                                  device="cpu")
    return (jp, jopts, jprior), (prob, opts, prior), model_type, rng


@pytest.mark.parametrize("case", list(SYSTEM_CASES))
def test_system_matches_jax(case):
    """(c) (f, g, B) of the folded system at N=3 frames, with missing
    markers, anneal, prior scale, velocity and extra anchors varied per
    frame, against the JAX `system_fn_batched` with `fold_weights=True`
    (Pallas in interpret mode): within 5e-4 of each output's max, since the
    JAX B takes the bf16 hi/lo path (`jac_precision="high"`); the port's
    unfolded system agrees with its folded one to 1e-6."""
    (jp, jopts, jprior), (prob, opts, prior), model_type, rng = \
        _system_pair(case)
    N, M = 3, prob.num_markers
    P = prob.sub_model.pose_dof
    D = prob.tables.dof
    E = D - 3 - P
    x = (rng.normal(size=(N, D)) * 0.2).astype(np.float32)
    mask = np.ones((N, M), np.float32)
    mask[0, :2] = 0.0
    mask[2, 5] = 0.0
    aux = {
        "markers": (rng.normal(size=(N, M, 3)) * 0.3).astype(np.float32),
        "mask": mask,
        "wt_data": np.asarray([3.7, 400.0 * 46.0 / 9, 1.0], np.float32),
        "anneal": np.asarray([1.4, 1.0, 2.0], np.float32),
        "wt_pose_scale": np.asarray([5.0, 1.0, 10.0], np.float32),
        "velo_anchor": (rng.normal(size=(N, P)) * 0.1).astype(np.float32),
        "velo_on": np.asarray([1.0, 0.0, 1.0], np.float32),
        "extra_anchor": (rng.normal(size=(N, E)) * 0.1).astype(np.float32),
        "extra_on": np.asarray([1.0 if E else 0.0, 0.0, 0.0], np.float32),
    }
    sysj = jax_stageii.make_stageii_system(jp, jopts, jprior, model_type)
    assert sysj.system_fn_batched is not None
    f_r, g_r, B_r = sysj.system_fn_batched(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in aux.items()})
    if sysj.b_frame_minor:
        B_r = jnp.moveaxis(B_r, -1, 0)
    if not opts.optimize_dynamics:
        aux = {k: v for k, v in aux.items() if not k.startswith("extra_")}
    taux = {k: torch.as_tensor(v) for k, v in aux.items()}
    out = stageii.make_stageii_system(prob, opts, prior,
                                      model_type).system_fn(
        torch.as_tensor(x), taux)
    assert out[2].shape == (N, D, D)
    for name, a, r in zip(("f", "g", "B"), out, (f_r, g_r, B_r)):
        r = np.asarray(r)
        np.testing.assert_allclose(a.numpy(), r, atol=5e-4 * np.abs(r).max(),
                                   err_msg=name)
    unfolded = stageii.make_stageii_system(
        prob, dataclasses.replace(opts, fold_weights=False), prior,
        model_type).system_fn(torch.as_tensor(x), taux)
    for a, b in zip(out, unfolded):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-6 * float(b.abs().max()))


# ---- (d): whole folded solves --------------------------------------------------

def _solve_problem(E: int):
    """A tiny SMPL+H problem with E DMPL dims (E = 0: none): 300 verts,
    12 markers, F=6, anchors every 2nd frame, a marker pair missing in
    frame 1; observations from the port's own forward model."""
    rng = np.random.default_rng(21)
    M, F = 12, 6
    model = make_synthetic_model("smplh", num_verts=300, seed=6,
                                 dof_per_hand=6, num_shape_dirs=16 + E,
                                 device="cpu")
    opts = stageii.StageIIOptions(maxiter=30, smoothing_sweeps=1,
                                  anchor_stride=2, optimize_fingers=True,
                                  optimize_dynamics=E > 0, num_dmpls=E or 8)
    betas = (rng.normal(size=16) * 0.3).astype(np.float32)
    can_v = model.v_template + torch.einsum(
        "vcb,b->vc", model.shapedirs[..., :16], torch.as_tensor(betas))
    latents = can_v[rng.choice(can_v.shape[0], M, replace=False)].numpy()
    prob = stageii.prepare_stageii_problem(model, betas, latents, opts,
                                           device="cpu")
    P = model.pose_dof
    x_true = np.concatenate([rng.normal(size=(F, 3)) * 0.05,
                             rng.normal(size=(F, P)) * 0.08,
                             rng.normal(size=(F, E)) * 0.3], 1)
    obs = stageii.simulate_markers(prob, opts,
                                   torch.as_tensor(x_true, dtype=torch.float32))
    mask = np.ones((F, M), bool)
    mask[1, :2] = False
    return prob, opts, obs, mask


def _solve(prob, opts, obs, mask, fold: bool):
    return stageii.mosh_stageii_solve(
        prob, dataclasses.replace(opts, fold_weights=fold), obs, mask,
        device="cpu")


@pytest.mark.parametrize("E", [0, 8])
def test_folded_solve_is_unfolded_solve(E):
    """(d) at E=0 and inline the CPU's folded solve is the unfolded one bit
    for bit: the plain fold computes the system's own weighting. chip_smoke.py
    phase 3d relies on this to hold the card's folded solve to phase 3's and
    3b's CPU solves."""
    prob, opts, obs, mask = _solve_problem(E)
    assert prob.tables.route == ("ext" if E else "")
    a, b = (_solve(prob, opts, obs, mask, fold) for fold in (False, True))
    for name in ("markers_sim", "trans", "pose", "extra", "data_err",
                 "iterations"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert a.host_syncs == b.host_syncs


# Perturbed solves of the E=20 problem: its observations moved by 1e-7 m
# (seeds 7 and 8) move the unfolded solve's mean marker error by up to
# 0.47 mm and its fitted markers by up to 45 mm (measured once on the CPU):
# 20 DMPL dims on 12 markers are barely observed, so the solve is chaotic in
# the rounding. The folded solve is held to FLOOR_FACTOR times that floor.
FLOOR_SEEDS = (7, 8)
FLOOR_FACTOR = 2.0


def test_tiled_folded_solve():
    """(d) 20 DMPL dims (the tiled route), folded: fits its markers under
    the 3.5 mm of tests/test_torch_face.py's wide-DMPL solve, and differs
    from the unfolded solve (mean marker error, fitted markers) by at most
    FLOOR_FACTOR times what 1e-7 m of observation noise moves the unfolded
    solve: the weighted extra columns round differently."""
    prob, opts, obs, mask = _solve_problem(20)
    assert prob.tables.route == "tiled"
    a, b = (_solve(prob, opts, obs, mask, fold) for fold in (False, True))
    err = lambda r: float(r.data_err.mean()) * 1e3
    wander = lambda r: float((r.markers_sim - a.markers_sim).abs().max()) * 1e3
    floor_err, floor_wander = 0.0, 0.0
    for seed in FLOOR_SEEDS:
        noise = 1e-7 * torch.randn(obs.shape,
                                   generator=torch.Generator().manual_seed(seed))
        c = _solve(prob, opts, obs + noise, mask, False)
        floor_err = max(floor_err, abs(err(c) - err(a)))
        floor_wander = max(floor_wander, wander(c))
    assert err(b) < 3.5
    assert abs(err(b) - err(a)) <= FLOOR_FACTOR * floor_err
    assert wander(b) <= FLOOR_FACTOR * floor_wander
