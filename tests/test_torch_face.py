"""The port's SMPL-X face path (jaw and expressions, the tiled extras route)
against the JAX package, on the CPU.

(a) the extras tables at E=20 and E=80 against
    `prepare_marker_jac_tables(extra_cols=...)`;
(b) `marker_sim_and_jacobian` / `marker_sim` through the tiled route (on
    CPU tensors: the plain versions of the tiled Hopper kernels) against
    the JAX package's tiled Pallas kernels in interpret mode, expression
    columns at E=20 (two full chunks of 8 and a padded one) and E=80, DMPL
    columns at E=20;
(c) the tiled route's plain versions against the inline route at E=16, and
    its E extra columns against `torch.func.jacfwd` of `lbs_forward`;
(d) the batched Gauss-Newton system (f, g, B) and cost with optimize_face at
    E=20 against the JAX `make_stageii_system`;
(e) the whole `mosh_stageii_solve` of a small SMPL-X problem with 80
    expressions against the JAX package's solve in a fresh subprocess, and
    a solve with 20 DMPL dims through the tiled route;
(f) the SMPL-X eyeball mask and `prepare_stageii_problem`'s default;
(g) the direction kernel's width guard.

Inputs are made from numpy seeds and handed to both packages.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from moshpp_tpu.markers.vids import smplx_eyeball_mask as jax_eyeball_mask
from moshpp_tpu.models import lbs_forward as jax_lbs_forward
from moshpp_tpu.models import make_synthetic_model as jax_make_model
from moshpp_tpu.ops.marker_transform import (
    marker_coeffs as jax_coeffs, reconstruct_markers as jax_reconstruct,
    select_frame_indices as jax_select)
from moshpp_tpu.ops.pallas_marker_jac import (
    INLINE_MAX_EXTRAS,
    marker_sim as jax_marker_sim,
    marker_sim_and_jacobian as jax_marker_sim_and_jacobian,
    prepare_marker_jac_tables as jax_prepare_tables)
from moshpp_tpu.ops.surface import vertex_normals as jax_normals
from moshpp_tpu.pipeline import stageii as jax_stageii
from moshpp_tpu.priors import make_gmm_prior as jax_make_prior

from moshpp_torch.markers.vids import smplx_eyeball_mask
from moshpp_torch.models import lbs_forward, make_synthetic_model
from moshpp_torch.models.body_model import surface_model_from_arrays
from moshpp_torch.models.kintree import DEFAULT_PARENTS
from moshpp_torch.models.synthetic import synthetic_model_arrays
from moshpp_torch.ops import marker_jac as mj
from moshpp_torch.ops.marker_transform import (MarkerFrameIndices,
                                               reconstruct_markers)
from moshpp_torch.pipeline import stageii
from moshpp_torch.priors.gmm import gmm_prior_from_arrays
from moshpp_torch.solver import pcg

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
NB = 6          # betas of the marker-function problems
_MODEL_FIELDS = ("v_template", "shapedirs", "posedirs", "weights",
                 "joint_template", "joint_shapedirs", "hands_components",
                 "hands_mean", "faces")


# ---- marker functions: (a)-(c) -------------------------------------------------

def _extra_cols(mode: str, E: int):
    """Shapedirs columns of the extras: DMPL right after the betas, or
    expressions behind a gap of zeroed columns (as SMPL-X's are)."""
    start = NB if mode == "dmpl" else NB + 2
    return list(range(start, start + E))


def _marker_problem(mode: str, E: int, seed: int = 4):
    """A 300-vertex SMPL-X (dof_per_hand=6, 96 shape dirs), 7 markers, F=3,
    in both packages, with the E extra columns of `mode`."""
    rng = np.random.default_rng(seed)
    jm = jax_make_model("smplx", num_verts=300, seed=4, dof_per_hand=6,
                        num_shape_dirs=96)
    tm = make_synthetic_model("smplx", num_verts=300, seed=4, dof_per_hand=6,
                              num_shape_dirs=96, device="cpu")
    betas = (rng.normal(size=NB) * 0.3).astype(np.float32)
    can_v = np.asarray(jm.v_template) + np.einsum(
        "vcb,b->vc", np.asarray(jm.shapedirs)[..., :NB], betas)
    vn = np.asarray(jax_normals(jnp.asarray(can_v), jm.faces))
    vids = rng.choice(can_v.shape[0], 7, replace=False)
    latents = (can_v[vids] + vn[vids] * 0.0095).astype(np.float32)
    idx = jax_select(jnp.asarray(can_v), jnp.asarray(latents))
    coeffs = jax_coeffs(jnp.asarray(can_v), jnp.asarray(latents), idx)
    cols = _extra_cols(mode, E)
    jt = jax_prepare_tables(jm, idx, coeffs, jnp.asarray(betas),
                            extra_cols=cols)
    tidx = MarkerFrameIndices(*[torch.as_tensor(np.array(c)) for c in idx])
    tcoeffs = torch.as_tensor(np.array(coeffs))
    tt = mj.prepare_marker_jac_tables(tm, tidx, tcoeffs,
                                      torch.as_tensor(betas), extra_cols=cols)
    P = tm.pose_dof
    F = 3
    x = np.concatenate([rng.normal(size=(F, 3 + P)) * 0.3,
                        rng.normal(size=(F, E)) * 0.3], 1).astype(np.float32)
    return dict(jm=jm, jt=jt, tm=tm, tt=tt, x=x, betas=betas, cols=cols,
                idx=tidx, coeffs=tcoeffs)


@pytest.mark.parametrize("E", [20, 80])
def test_tables_match_jax(E):
    """(a) djnt, dtrel (J, E, 3) and dv (M, 3 frame verts, E, 3) against the
    JAX tables re-laid out, and the shift tables jdirs / vdirs as their
    re-layouts. Exact up to float32 rounding of the host sums."""
    p = _marker_problem("expr", E)
    jt, tt = p["jt"], p["tt"]
    J, M = tt.num_joints, tt.num_markers
    assert tt.n_extra == jt.n_extra == E and tt.route == "tiled"
    djnt = np.asarray(jt.djntE).reshape(J, E, 3)
    dtrel = np.asarray(jt.dtrelE).reshape(J, E, 3)
    np.testing.assert_allclose(tt.djnt.numpy(), djnt, rtol=0, atol=1e-7)
    np.testing.assert_allclose(tt.dtrel.numpy(), dtrel, rtol=0, atol=1e-7)
    dv = np.asarray(jt.dvE).reshape(E, 3, M, 128)[..., :3]    # [e, c, m, k]
    np.testing.assert_array_equal(tt.dv.numpy(), dv.transpose(2, 3, 0, 1))
    np.testing.assert_allclose(
        tt.jdirs.numpy().reshape(E, 2, J, 3),
        np.stack([dtrel, djnt]).transpose(2, 0, 1, 3), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(tt.vdirs.numpy().reshape(E, M, 3, 3),
                                  dv.transpose(0, 2, 3, 1))


@pytest.mark.parametrize("mode,E", [("expr", 20), ("expr", 80), ("dmpl", 20)])
def test_sim_and_jacobian_match_pallas(mode, E):
    """(b) the tiled route's plain versions against the Pallas
    `_smalls_kernel_tiled`, `_extras_tangent_kernel`, `_marker_kernel_tiled`
    and `_extras_cols_kernel` and their primal twins (interpret mode): sim
    within 3e-5 m, jm within 3e-4 max(|jm|, 1), as tests/test_pallas_jac.py
    holds the TPU kernels; the light sim within 1e-6 m of the full one."""
    assert E > INLINE_MAX_EXTRAS
    p = _marker_problem(mode, E)
    x = p["x"]
    sim_r, jm_r = jax_marker_sim_and_jacobian(p["jm"], p["jt"], jnp.asarray(x),
                                              interpret=True)
    sim, jmat = mj.marker_sim_and_jacobian(p["tm"], p["tt"], torch.tensor(x))
    D = 3 + p["tm"].pose_dof + E
    assert jmat.shape == (3, 7, 3, D)
    np.testing.assert_allclose(sim.numpy(), np.asarray(sim_r), atol=3e-5)
    scale = max(float(np.abs(np.asarray(jm_r)).max()), 1.0)
    np.testing.assert_allclose(jmat.numpy(), np.asarray(jm_r),
                               atol=3e-4 * scale)
    sim_light = mj.marker_sim(p["tm"], p["tt"], torch.tensor(x))
    np.testing.assert_allclose(
        sim_light.numpy(),
        np.asarray(jax_marker_sim(p["jm"], p["jt"], jnp.asarray(x),
                                  interpret=True)), atol=3e-5)
    np.testing.assert_allclose(sim_light.numpy(), sim.numpy(), atol=1e-6)


def test_tiled_route_matches_inline_route():
    """(c) at E=16, the widest inline width, the tiled route (shift matmuls,
    fk_smalls<., tiled>, extras_tangent, marker_rows<., tiled>,
    extras_cols) against the inline route: sim, jm and the stages' shared
    outputs within 1e-5."""
    p = _marker_problem("expr", 16)
    tm, tt = p["tm"], p["tt"]
    assert tt.route == "ext"
    x = torch.tensor(p["x"])
    sim_i, jm_i = mj.marker_sim_and_jacobian(tm, tt, x)
    sim_t, jm_t = mj.sim_and_jacobian_tiled(tm, tt, x)
    np.testing.assert_allclose(sim_t.numpy(), sim_i.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(jm_t.numpy(), jm_i.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(mj.sim_tiled(tm, tt, x).numpy(),
                               mj.marker_sim(tm, tt, x).numpy(), rtol=0,
                               atol=1e-5)
    theta, _, extra = mj.kernel_inputs(tm, tt, x)
    inline = mj.fk_smalls(theta, tt, True, extra)
    jshift, _ = mj.extra_shifts(tt, extra)
    tiled = mj.fk_smalls_tiled(theta, jshift, tt, True)
    for f in ("grot", "atr", "feat", "wrot", "wtr", "dr"):
        np.testing.assert_allclose(getattr(tiled, f).numpy(),
                                   getattr(inline, f).numpy(), rtol=0,
                                   atol=1e-5, err_msg=f)
    datr = mj.extras_tangent(tiled.q, tiled.grot, tt)
    np.testing.assert_allclose(datr.numpy(), inline.datr.numpy(), rtol=0,
                               atol=1e-5)


def _float64(model):
    return dataclasses.replace(model, **{
        f: getattr(model, f).double() for f in _MODEL_FIELDS
        if getattr(model, f).is_floating_point()})


def test_extra_columns_match_jacfwd():
    """(c) all columns of jm at E=80, the extra ones included, against
    `torch.func.jacfwd` of the port's forward model with per-frame betas,
    run in float64: within 3e-4 max(|jm|, 1); sim within 3e-5 m."""
    E = 80
    p = _marker_problem("expr", E)
    tm64 = _float64(p["tm"])
    P = tm64.pose_dof
    cols = p["cols"]
    base = torch.zeros(cols[-1] + 1, dtype=torch.float64)
    base[:NB] = torch.as_tensor(p["betas"], dtype=torch.float64)
    coeffs = p["coeffs"].double()

    def sim_fn(x):
        betas = base.expand(x.shape[0], -1).clone()
        betas[:, cols] = x[:, 3 + P:]
        verts = lbs_forward(tm64, x[:, 3:3 + P], betas, x[:, :3])
        return reconstruct_markers(verts, p["idx"], coeffs)

    x64 = torch.as_tensor(p["x"], dtype=torch.float64)
    jac = torch.func.jacfwd(sim_fn)(x64)                  # (F, M, 3, F, D)
    F = x64.shape[0]
    jm_r = jac[torch.arange(F), :, :, torch.arange(F)]    # (F, M, 3, D)
    sim, jmat = mj.marker_sim_and_jacobian(p["tm"], p["tt"],
                                           torch.tensor(p["x"]))
    np.testing.assert_allclose(sim.numpy(), sim_fn(x64).numpy(), atol=3e-5)
    scale = max(float(jm_r.abs().max()), 1.0)
    np.testing.assert_allclose(jmat.numpy(), jm_r.numpy(), atol=3e-4 * scale)
    assert float(jm_r[..., 3 + P:].abs().max()) > 1e-3   # the columns are live


# ---- the stage-ii slice with expressions: (d) and (e) ----------------------------

FACE_OPTS = dict(maxiter=40, smoothing_sweeps=1, optimize_face=True,
                 optimize_fingers=True, expr_start=16)


def face_problem(E: int = 80, obs_noise: float = 0.0):
    """A small SMPL-X problem with E expressions, built by the JAX package,
    at the shapes of tests/test_extras.py's tiled face solve: 500 verts, 96
    shape dirs (16 betas, expressions from column 16), dof_per_hand=6, 16
    markers, F=4, smooth truth motion with the eyes still and expressions
    drifting per frame; observations moved by `obs_noise` m of seeded
    Gaussian noise. The JAX solve takes the XLA Jacobian path."""
    rng = np.random.default_rng(14)
    M, F, nb = 16, 4, 16
    model = jax_make_model("smplx", num_verts=500, seed=14, num_betas=16,
                           num_shape_dirs=96, dof_per_hand=6)
    opts = jax_stageii.StageIIOptions(**FACE_OPTS, num_expressions=E,
                                      jac_backend="xla")
    prior = jax_make_prior(dim=63, num_components=3, seed=15, scale=0.3)
    betas = (rng.normal(size=nb) * 0.3).astype(np.float32)
    can_v = np.asarray(model.v_template) + np.einsum(
        "vcb,b->vc", np.asarray(model.shapedirs)[..., :nb], betas)
    vn = np.asarray(jax_normals(jnp.asarray(can_v), model.faces))
    vids = rng.choice(can_v.shape[0], M, replace=False)
    latents = (can_v[vids] + vn[vids] * 0.0095).astype(np.float32)
    idx = jax_select(jnp.asarray(can_v), jnp.asarray(latents))
    coeffs = jax_coeffs(jnp.asarray(can_v), jnp.asarray(latents), idx)
    P = model.pose_dof
    poses = np.zeros((F, P), np.float32)
    poses[0] = rng.normal(size=P) * 0.08
    for f in range(1, F):
        poses[f] = poses[f - 1] + rng.normal(size=P) * 0.03
    poses[:, 69:75] = 0.0
    trans = np.cumsum(rng.normal(size=(F, 3)) * 0.02, axis=0).astype(
        np.float32)
    expr = np.zeros((F, E), np.float32)
    expr[0] = rng.normal(size=E) * 0.3
    for f in range(1, F):
        expr[f] = 0.97 * expr[f - 1] + rng.normal(size=E) * 0.03

    def sim(p, t, b):
        return jax_reconstruct(jax_lbs_forward(model, p, b, t), idx, coeffs)

    shape = np.concatenate([np.broadcast_to(betas, (F, nb)), expr], 1)
    obs = np.asarray(jax.vmap(sim)(jnp.asarray(poses), jnp.asarray(trans),
                                   jnp.asarray(shape)))
    obs = obs + obs_noise * np.random.default_rng(7).normal(size=obs.shape)
    mask = np.ones((F, M), bool)
    mask[1, :2] = False
    prob = jax_stageii.prepare_stageii_problem(model, betas, latents,
                                               opts=opts)
    return dict(prob=prob, opts=opts, prior=prior,
                obs=obs.astype(np.float32), mask=mask, expr=expr)


def port_problem(fp, E: int):
    """The port's (problem, options, prior) from the JAX problem's frozen
    fields, so both solve the same marker frames."""
    jp, jprior = fp["prob"], fp["prior"]
    sub = jp.sub_model
    model = surface_model_from_arrays(
        {f: np.asarray(getattr(sub, f)) for f in _MODEL_FIELDS},
        sub.model_type, sub.parents, sub.dof_per_hand,
        num_betas=sub.num_betas, skin_k=sub.skin_k, device="cpu")
    opts = stageii.StageIIOptions(**FACE_OPTS, num_expressions=E)
    frame_idx = np.stack([np.asarray(c) for c in
                          (jp.frame_c0, jp.frame_c1, jp.frame_c2)], axis=1)
    prob = stageii.problem_from_arrays(model, frame_idx, np.asarray(jp.coeffs),
                                       np.asarray(jp.betas), opts,
                                       device="cpu")
    prior = gmm_prior_from_arrays(np.asarray(jprior.means),
                                  np.asarray(jprior.chols),
                                  np.asarray(jprior.sqrt_neg_log_w),
                                  device="cpu")
    return prob, opts, prior


@pytest.fixture(scope="module")
def face():
    """The JAX face problem with 80 expressions. Its JAX side does not
    depend on E (the XLA Jacobian path bakes no tables), so (d) reuses it at
    E=20."""
    return face_problem(80)


def test_system_matches_jax(face):
    """(d) (f, g, B) and the cost at E=20 (the tiled route) with the jaw
    and expression terms against the JAX per-frame system under vmap, with
    anneal, prior scale and velocity anchors varied per frame: within 1e-4
    of each output's max."""
    E = 20
    fp = dict(face, opts=dataclasses.replace(face["opts"], num_expressions=E))
    prob, opts, prior = port_problem(fp, E)
    assert prob.tables.route == "tiled"
    rng = np.random.default_rng(8)
    N = 4
    P = prob.sub_model.pose_dof
    D = 3 + P + E
    x = (rng.normal(size=(N, D)) * 0.15).astype(np.float32)
    aux = {
        "markers": np.repeat(fp["obs"][:1], N, 0),
        "mask": np.repeat(fp["mask"][1:2].astype(np.float32), N, 0),
        "wt_data": np.full(N, 400.0 * 46.0 / 16, np.float32),
        "anneal": np.asarray([1.0, 1.5, 2.0, 1.0], np.float32),
        "wt_pose_scale": np.asarray([1.0, 10.0, 5.0, 1.0], np.float32),
        "velo_anchor": (rng.normal(size=(N, P)) * 0.1).astype(np.float32),
        "velo_on": np.asarray([0.0, 1.0, 1.0, 0.0], np.float32),
    }
    jaux = {k: jnp.asarray(v) for k, v in aux.items()}
    jaux["extra_anchor"] = jnp.zeros((N, E))
    jaux["extra_on"] = jnp.zeros((N,))
    sysj = jax_stageii.make_stageii_system(fp["prob"], fp["opts"],
                                           fp["prior"], "smplx")
    ref = jax.jit(jax.vmap(sysj.system_fn))(jnp.asarray(x), jaux)
    cost_ref = np.asarray(jax.jit(jax.vmap(sysj.cost_fn))(jnp.asarray(x),
                                                          jaux))

    syst = stageii.make_stageii_system(prob, opts, prior, "smplx")
    taux = {k: torch.as_tensor(v) for k, v in aux.items()}
    out = syst.system_fn(torch.as_tensor(x), taux)
    assert out[2].shape == (N, D, D)
    for name, a, r in zip(("f", "g", "B"), out, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(a.numpy(), r, atol=1e-4 * np.abs(r).max(),
                                   err_msg=name)
    cost = syst.cost_fn(torch.as_tensor(x), taux).numpy()
    np.testing.assert_allclose(cost, cost_ref,
                               atol=1e-4 * np.abs(cost_ref).max())
    np.testing.assert_allclose(cost, out[0].numpy(),
                               atol=1e-5 * np.abs(out[0].numpy()).max())


def jax_face_solve(obs_noise: float) -> dict:
    """The JAX package's solve of `face_problem(80, obs_noise)` (numpy
    out)."""
    fp = face_problem(80, obs_noise)
    res = jax_stageii.mosh_stageii_solve(fp["prob"], fp["opts"], fp["obs"],
                                         fp["mask"], prior=fp["prior"],
                                         model_type="smplx")
    return {k: np.asarray(getattr(res, k))
            for k in ("data_err", "markers_sim", "trans", "extra")}


# The child's compilation cache lives under the temporary directory of the
# process that runs the tests, as in tests/test_torch_extras.py.
_CHILD = """
import os, pickle, sys, tempfile
sys.path.insert(0, sys.argv[3])
sys.path.insert(0, sys.argv[4])
import jax
jax.config.update("jax_platforms", "cpu")
from moshpp_tpu.utils.cache import setup_jax_cache
setup_jax_cache(os.path.join(tempfile.gettempdir(), "moshpp_tpu_jax_cache"))
from test_torch_face import jax_face_solve
with open(sys.argv[1], "wb") as f:
    pickle.dump(jax_face_solve(float(sys.argv[2])), f)
"""


@pytest.fixture(scope="module", autouse=True)
def jax_reference(tmp_path_factory):
    """`jax_face_solve(0)` in a fresh interpreter (XLA:CPU has crashed
    compiling solver programs in a process with much compile state behind
    it, tests/golden_common.py), started as this module's tests begin so
    that its ~40 s run beside them; (e) waits for its result."""
    out = tmp_path_factory.mktemp("face") / "jax_solve.pkl"
    proc = subprocess.Popen([sys.executable, "-c", _CHILD, str(out), "0.0",
                             REPO, TESTS], stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)

    def result() -> dict:
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err.decode()[-2000:]
        with open(out, "rb") as f:
            return pickle.load(f)

    yield result
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


# Max |expression| difference between two JAX solves of this problem whose
# observations differ by 1e-7 m (`jax_face_solve(0)` against
# `jax_face_solve(1e-7)`, measured once on the CPU: 0.0874, with the fitted
# markers 0.27 mm and trans 11 mm apart: 80 expressions on 16 markers are
# weakly observed): the solve's own sensitivity to rounding. The port is
# held to EXPR_FLOOR_FACTOR times it (it measured 0.100 from the JAX solve).
EXPR_JAX_FLOOR = 0.0874
EXPR_FLOOR_FACTOR = 2.0


def test_solve_matches_jax(face, jax_reference):
    """(e) the whole CPU solve with 80 expressions (the tiled route) against
    the JAX package's: mean marker error within 0.1 mm, the expressions
    within EXPR_FLOOR_FACTOR times the JAX-vs-JAX floor."""
    prob, opts, prior = port_problem(face, 80)
    assert prob.tables.route == "tiled"
    res = stageii.mosh_stageii_solve(prob, opts, face["obs"], face["mask"],
                                     prior=prior, model_type="smplx",
                                     device="cpu")
    assert res.extra.shape == (4, 80)
    assert res.fullpose.shape == (4, 165)
    ref = jax_reference()
    err_mm = float(res.data_err.mean()) * 1e3
    assert abs(err_mm - ref["data_err"].mean() * 1e3) < 0.1
    d_expr = float(np.abs(res.extra.numpy() - ref["extra"]).max())
    assert d_expr <= EXPR_FLOOR_FACTOR * EXPR_JAX_FLOOR, d_expr


def test_wide_dmpl_solve_runs():
    """More than 16 DMPL dims take the tiled route through the whole solve:
    a tiny SMPL+H problem with 20 DMPLs (observations from the port's own
    forward model) fits its markers to under 3.5 mm, as tests/test_extras.py
    holds the JAX package's tiled face solve."""
    rng = np.random.default_rng(21)
    M, F, E = 12, 4, 20
    model = make_synthetic_model("smplh", num_verts=300, seed=6,
                                 dof_per_hand=6, num_shape_dirs=16 + E,
                                 device="cpu")
    opts = stageii.StageIIOptions(maxiter=30, smoothing_sweeps=1,
                                  optimize_dynamics=True, num_dmpls=E)
    betas = (rng.normal(size=16) * 0.3).astype(np.float32)
    can_v = model.v_template + torch.einsum(
        "vcb,b->vc", model.shapedirs[..., :16], torch.as_tensor(betas))
    latents = can_v[rng.choice(can_v.shape[0], M, replace=False)].numpy()
    prob = stageii.prepare_stageii_problem(model, betas, latents, opts,
                                           device="cpu")
    assert prob.tables.route == "tiled"
    P = model.pose_dof
    x_true = np.concatenate([rng.normal(size=(F, 3)) * 0.05,
                             rng.normal(size=(F, P)) * 0.08,
                             rng.normal(size=(F, E)) * 0.3], 1)
    obs = stageii.simulate_markers(prob, opts,
                                   torch.as_tensor(x_true, dtype=torch.float32))
    res = stageii.mosh_stageii_solve(prob, opts, obs, np.ones((F, M), bool),
                                     device="cpu")
    assert res.extra.shape == (F, E) and torch.isfinite(res.extra).all()
    assert float(res.data_err.mean()) * 1e3 < 3.5


# ---- (f) the eyeball mask, (g) the direction guard --------------------------------

@pytest.mark.parametrize("V", [10475, 10242])
def test_eyeball_mask_matches_jax(V):
    mask = smplx_eyeball_mask(V)
    np.testing.assert_array_equal(mask, jax_eyeball_mask(V))
    assert int(mask.sum()) == (1092 if V == 10475 else 0)


def test_prepare_excludes_eyeballs_by_default():
    """A 10475-vertex SMPL-X whose last 1092 vertices (the eyeballs) sit
    nearest to every latent marker: by default no marker frame uses them;
    with an empty mask the frames take them."""
    a = synthetic_model_arrays("smplx", num_verts=300, num_betas=16,
                               num_shape_dirs=16, dof_per_hand=6, seed=2)
    V = 10475
    per_vertex = ("v_template", "shapedirs", "posedirs", "weights")
    arrays = dict(a, **{f: np.resize(a[f], (V,) + a[f].shape[1:])
                        for f in per_vertex})
    rng = np.random.default_rng(3)
    eyes = np.arange(9383, V)
    arrays["v_template"][eyes] += (rng.normal(size=(len(eyes), 3)) * 0.003
                                   ).astype(np.float32)
    model = surface_model_from_arrays(arrays, "smplx",
                                      DEFAULT_PARENTS["smplx"], 6,
                                      device="cpu")
    latents = arrays["v_template"][rng.choice(eyes, 8, replace=False)] + 1e-4
    betas = np.zeros(16, np.float32)
    opts = stageii.StageIIOptions()
    eye_rows = torch.as_tensor(arrays["v_template"][eyes])

    def uses_eyes(prob):
        rows = prob.sub_model.v_template
        return bool((torch.cdist(rows, eye_rows) == 0).any())

    assert not uses_eyes(stageii.prepare_stageii_problem(
        model, betas, latents, opts, device="cpu"))
    assert uses_eyes(stageii.prepare_stageii_problem(
        model, betas, latents, opts, exclude_vertex_mask=np.zeros(V, bool),
        device="cpu"))


def test_direction_width_guard():
    """(g) the direction kernel holds B in one block's shared memory: the
    wrapper raises one past its widest D (>= 240), naming the bytes, on
    every device; the widest D runs."""
    D = pcg.MAX_DIRECTION_WIDTH
    assert D >= 240 and pcg.direction_smem_bytes(D) <= pcg.SMEM_PER_BLOCK
    args = pcg.direction_test_system(2, D + 1, 5.0, seed=0, device="cpu")
    with pytest.raises(ValueError, match=str(pcg.direction_smem_bytes(D + 1))):
        pcg.dogleg_direction_batched(*args, 24, 1e-8)
    args = pcg.direction_test_system(2, D, 5.0, seed=0, device="cpu")
    p, _, pred = pcg.dogleg_direction_batched(*args, 24, 1e-8)
    assert torch.isfinite(p).all() and torch.isfinite(pred).all()
