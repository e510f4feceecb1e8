"""The port's extra shape dims (DMPL soft-tissue coefficients) against the
JAX package, on the CPU.

(a) the extras tables against `prepare_marker_jac_tables(extra_cols=...)`;
(b) `marker_sim_and_jacobian` / `marker_sim` (on CPU tensors: the plain
    versions of the E-carrying Hopper kernels) against the JAX package's
    Pallas kernels in interpret mode, with the extras as DMPL columns and as
    expression columns behind a gap, at E=4 and E=8;
(c) the E extra columns against `torch.func.jacfwd` of the port's own
    `lbs_forward` (per-frame betas) and `reconstruct_markers`;
(d) the batched Gauss-Newton system (f, g, B) and cost at E=8 against the
    JAX `make_stageii_system`;
(e) the whole `mosh_stageii_solve` of a tiny SMPL+H problem with 8 DMPLs
    against the JAX package's solve in a fresh subprocess.

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

from moshpp_tpu.models import lbs_forward as jax_lbs_forward
from moshpp_tpu.models import make_synthetic_model as jax_make_model
from moshpp_tpu.ops.marker_transform import (
    marker_coeffs as jax_coeffs, reconstruct_markers as jax_reconstruct,
    select_frame_indices as jax_select)
from moshpp_tpu.ops.pallas_marker_jac import (
    marker_sim as jax_marker_sim,
    marker_sim_and_jacobian as jax_marker_sim_and_jacobian,
    prepare_marker_jac_tables as jax_prepare_tables)
from moshpp_tpu.ops.surface import vertex_normals as jax_normals
from moshpp_tpu.pipeline import stageii as jax_stageii
from moshpp_tpu.priors import make_gmm_prior as jax_make_prior

from moshpp_torch.models import lbs_forward, make_synthetic_model
from moshpp_torch.models.body_model import surface_model_from_arrays
from moshpp_torch.ops.marker_jac import (marker_sim, marker_sim_and_jacobian,
                                         prepare_marker_jac_tables)
from moshpp_torch.ops.marker_transform import (MarkerFrameIndices,
                                               reconstruct_markers)
from moshpp_torch.pipeline import stageii
from moshpp_torch.priors.gmm import gmm_prior_from_arrays

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


def _per_frame_betas(betas, cols, extra):
    """(F, cols[-1] + 1) shape coefficients: betas, zeros, the extras."""
    out = np.zeros((extra.shape[0], cols[-1] + 1), np.float32)
    out[:, :len(betas)] = betas
    out[:, cols] = extra
    return out


def _marker_problem(mode: str, E: int, seed: int = 4):
    """A 300-vertex SMPL+H (dof_per_hand=6, 16 shape dirs), 7 markers, F=3,
    in both packages, with the E extra columns of `mode`."""
    rng = np.random.default_rng(seed)
    jm = jax_make_model("smplh", num_verts=300, seed=4, dof_per_hand=6,
                        num_shape_dirs=16)
    tm = make_synthetic_model("smplh", num_verts=300, seed=4, dof_per_hand=6,
                              num_shape_dirs=16, device="cpu")
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
    tt = prepare_marker_jac_tables(tm, tidx, tcoeffs, torch.as_tensor(betas),
                                   extra_cols=cols)
    P = tm.pose_dof
    F = 3
    x = np.concatenate([rng.normal(size=(F, 3 + P)) * 0.3,
                        rng.normal(size=(F, E)) * 0.5], 1).astype(np.float32)
    return dict(jm=jm, jt=jt, tm=tm, tt=tt, x=x, betas=betas, cols=cols,
                idx=tidx, coeffs=tcoeffs)


@pytest.mark.parametrize("mode", ["dmpl", "expr"])
def test_tables_match_jax(mode):
    """(a) djnt, dtrel (J, E, 3) and dv (M, 3 frame verts, E, 3) against the
    JAX tables re-laid out: (J, 3E) columns e*3+c and the (3E, M*128) lane
    bands [e*3+c, m*128+k]. Exact up to float32 rounding of the host sums."""
    E = 8
    p = _marker_problem(mode, E)
    jt, tt = p["jt"], p["tt"]
    J, M = tt.num_joints, tt.num_markers
    assert tt.n_extra == jt.n_extra == E
    np.testing.assert_allclose(tt.djnt.numpy(),
                               np.asarray(jt.djntE).reshape(J, E, 3),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(tt.dtrel.numpy(),
                               np.asarray(jt.dtrelE).reshape(J, E, 3),
                               rtol=0, atol=1e-7)
    dv = np.asarray(jt.dvE).reshape(E, 3, M, 128)[..., :3]    # [e, c, m, k]
    np.testing.assert_array_equal(tt.dv.numpy(), dv.transpose(2, 3, 0, 1))


@pytest.mark.parametrize("mode,E", [("dmpl", 4), ("dmpl", 8), ("expr", 4),
                                    ("expr", 8)])
def test_sim_and_jacobian_match_pallas(mode, E):
    """(b) the plain versions of fk_smalls/marker_rows<.,ext> against the
    Pallas `_smalls_kernel_ext`/`_marker_kernel_ext` and their primal twins
    (interpret mode): sim within 3e-5 m, jm within 3e-4 max(|jm|, 1), as
    tests/test_pallas_jac.py holds the TPU kernels against jacfwd."""
    p = _marker_problem(mode, E)
    x = p["x"]
    sim_r, jm_r = jax_marker_sim_and_jacobian(p["jm"], p["jt"], jnp.asarray(x),
                                              interpret=True)
    sim, jmat = marker_sim_and_jacobian(p["tm"], p["tt"], torch.tensor(x))
    D = 3 + p["tm"].pose_dof + E
    assert jmat.shape == (3, 7, 3, D)
    np.testing.assert_allclose(sim.numpy(), np.asarray(sim_r), atol=3e-5)
    scale = max(float(np.abs(np.asarray(jm_r)).max()), 1.0)
    np.testing.assert_allclose(jmat.numpy(), np.asarray(jm_r),
                               atol=3e-4 * scale)
    sim_light = marker_sim(p["tm"], p["tt"], torch.tensor(x))
    np.testing.assert_allclose(
        sim_light.numpy(),
        np.asarray(jax_marker_sim(p["jm"], p["jt"], jnp.asarray(x),
                                  interpret=True)), atol=3e-5)
    np.testing.assert_allclose(sim_light.numpy(), sim.numpy(), atol=1e-6)


def _float64(model):
    return dataclasses.replace(model, **{
        f: getattr(model, f).double() for f in _MODEL_FIELDS
        if getattr(model, f).is_floating_point()})


@pytest.mark.parametrize("mode", ["dmpl", "expr"])
def test_extra_columns_match_jacfwd(mode):
    """(c) all columns of jm, the E extra ones included, against
    `torch.func.jacfwd` of the port's forward model with per-frame betas,
    run in float64: within 3e-4 max(|jm|, 1); sim within 3e-5 m."""
    E = 8
    p = _marker_problem(mode, E)
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
    sim, jmat = marker_sim_and_jacobian(p["tm"], p["tt"], torch.tensor(p["x"]))
    np.testing.assert_allclose(sim.numpy(), sim_fn(x64).numpy(), atol=3e-5)
    scale = max(float(jm_r.abs().max()), 1.0)
    np.testing.assert_allclose(jmat.numpy(), jm_r.numpy(), atol=3e-4 * scale)
    assert float(jm_r[..., 3 + P:].abs().max()) > 1e-3   # the columns are live


def test_lbs_forward_per_frame_betas_matches_jax():
    """Per-frame betas (N, B') in the port's batched `lbs_forward` against
    the JAX one-frame `lbs_forward` under vmap: within 1e-5 m."""
    rng = np.random.default_rng(11)
    jm = jax_make_model("smplh", num_verts=300, seed=4, dof_per_hand=6,
                        num_shape_dirs=24)
    tm = make_synthetic_model("smplh", num_verts=300, seed=4, dof_per_hand=6,
                              num_shape_dirs=24, device="cpu")
    N = 4
    pose = (rng.normal(size=(N, tm.pose_dof)) * 0.3).astype(np.float32)
    betas = (rng.normal(size=(N, 24)) * 0.5).astype(np.float32)
    trans = (rng.normal(size=(N, 3)) * 0.1).astype(np.float32)
    ref = jax.vmap(lambda p, b, t: jax_lbs_forward(jm, p, b, t))(
        jnp.asarray(pose), jnp.asarray(betas), jnp.asarray(trans))
    out = lbs_forward(tm, torch.tensor(pose), torch.tensor(betas),
                      torch.tensor(trans))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


# ---- the stage-ii slice with DMPLs: (d) and (e) ---------------------------------

DMPL_OPTS = dict(maxiter=40, smoothing_sweeps=1, anchor_stride=2,
                 optimize_fingers=True, optimize_dynamics=True, num_dmpls=8)


def dmpl_problem(obs_noise: float = 0.0):
    """A tiny SMPL+H problem with 8 DMPLs, built by the JAX package: 300
    verts, 24 shape dirs (16 betas, 8 DMPL columns), dof_per_hand=6, 10
    markers, F=4, smooth truth motion with DMPLs drifting per frame, one
    marker pair missing in frame 1; observations moved by `obs_noise` m of
    seeded Gaussian noise."""
    rng = np.random.default_rng(101)
    M, F, nb, E = 10, 4, 16, 8
    model = jax_make_model("smplh", num_verts=300, seed=9, dof_per_hand=6,
                           num_shape_dirs=24)
    opts = jax_stageii.StageIIOptions(**DMPL_OPTS)
    prior = jax_make_prior(dim=63, num_components=3, seed=13, scale=0.3)
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
    poses[0] = rng.normal(size=P) * 0.12
    for f in range(1, F):
        poses[f] = poses[f - 1] + rng.normal(size=P) * 0.03
    trans = np.cumsum(rng.normal(size=(F, 3)) * 0.02, axis=0).astype(
        np.float32)
    dmpl = np.zeros((F, E), np.float32)
    dmpl[0] = rng.normal(size=E) * 0.3
    for f in range(1, F):
        dmpl[f] = 0.97 * dmpl[f - 1] + rng.normal(size=E) * 0.03

    def sim(p, t, b):
        return jax_reconstruct(jax_lbs_forward(model, p, b, t), idx, coeffs)

    shape = np.concatenate([np.broadcast_to(betas, (F, nb)), dmpl], 1)
    obs = np.asarray(jax.vmap(sim)(jnp.asarray(poses), jnp.asarray(trans),
                                   jnp.asarray(shape)))
    obs = obs + obs_noise * np.random.default_rng(7).normal(size=obs.shape)
    mask = np.ones((F, M), bool)
    mask[1, :2] = False
    prob = jax_stageii.prepare_stageii_problem(model, betas, latents,
                                               opts=opts)
    return dict(prob=prob, opts=opts, prior=prior,
                obs=obs.astype(np.float32), mask=mask, dmpl=dmpl)


def port_problem(fp):
    """The port's (problem, options, prior) from the JAX problem's frozen
    fields, so both solve the same marker frames."""
    jp, jprior = fp["prob"], fp["prior"]
    sub = jp.sub_model
    model = surface_model_from_arrays(
        {f: np.asarray(getattr(sub, f)) for f in _MODEL_FIELDS},
        sub.model_type, sub.parents, sub.dof_per_hand,
        num_betas=sub.num_betas, skin_k=sub.skin_k, device="cpu")
    opts = stageii.StageIIOptions(**DMPL_OPTS)
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
def dmpl():
    fp = dmpl_problem()
    return fp, port_problem(fp)


def test_system_matches_jax(dmpl):
    """(d) (f, g, B) and the cost at E=8 against the JAX per-frame system
    under vmap, with anneal, prior scale, velocity and DMPL anchors varied
    per frame: within 1e-4 of each output's max."""
    fp, (prob, opts, prior) = dmpl
    rng = np.random.default_rng(8)
    N, E = 4, 8
    P = prob.sub_model.pose_dof
    D = 3 + P + E
    x = (rng.normal(size=(N, D)) * 0.15).astype(np.float32)
    aux = {
        "markers": np.repeat(fp["obs"][:1], N, 0),
        "mask": np.repeat(fp["mask"][1:2].astype(np.float32), N, 0),
        "wt_data": np.full(N, 400.0 * 46.0 / 10, np.float32),
        "anneal": np.asarray([1.0, 1.5, 2.0, 1.0], np.float32),
        "wt_pose_scale": np.asarray([1.0, 10.0, 5.0, 1.0], np.float32),
        "velo_anchor": (rng.normal(size=(N, P)) * 0.1).astype(np.float32),
        "velo_on": np.asarray([0.0, 1.0, 1.0, 0.0], np.float32),
        "extra_anchor": (rng.normal(size=(N, E)) * 0.3).astype(np.float32),
        "extra_on": np.asarray([0.0, 1.0, 0.0, 1.0], np.float32),
    }
    sysj = jax_stageii.make_stageii_system(fp["prob"], fp["opts"],
                                           fp["prior"], "smplh")
    jaux = {k: jnp.asarray(v) for k, v in aux.items()}
    ref = jax.vmap(sysj.system_fn)(jnp.asarray(x), jaux)
    cost_ref = np.asarray(jax.vmap(sysj.cost_fn)(jnp.asarray(x), jaux))

    syst = stageii.make_stageii_system(prob, opts, prior, "smplh")
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


def jax_dmpl_solve(obs_noise: float) -> dict:
    """The JAX package's solve of `dmpl_problem(obs_noise)` (numpy out)."""
    fp = dmpl_problem(obs_noise)
    res = jax_stageii.mosh_stageii_solve(fp["prob"], fp["opts"], fp["obs"],
                                         fp["mask"], prior=fp["prior"],
                                         model_type="smplh")
    return {k: np.asarray(getattr(res, k))
            for k in ("data_err", "markers_sim", "trans", "extra")}


# The child's compilation cache lives under the temporary directory of the
# process that runs the tests, so two checkouts tested side by side neither
# share its entries nor sweep each other's half-written ones.
_CHILD = """
import os, pickle, sys, tempfile
sys.path.insert(0, sys.argv[3])
sys.path.insert(0, sys.argv[4])
import jax
jax.config.update("jax_platforms", "cpu")
from moshpp_tpu.utils.cache import setup_jax_cache
setup_jax_cache(os.path.join(tempfile.gettempdir(), "moshpp_tpu_jax_cache"))
from test_torch_extras import jax_dmpl_solve
with open(sys.argv[1], "wb") as f:
    pickle.dump(jax_dmpl_solve(float(sys.argv[2])), f)
"""


def jax_dmpl_solve_subprocess(obs_noise: float = 0.0) -> dict:
    """`jax_dmpl_solve` in a fresh interpreter: XLA:CPU has crashed compiling
    solver programs in a process with much compile state behind it
    (tests/golden_common.py)."""
    with tempfile.NamedTemporaryFile(suffix=".pkl") as out:
        r = subprocess.run([sys.executable, "-c", _CHILD, out.name,
                            repr(obs_noise), REPO, TESTS],
                           capture_output=True, timeout=900)
        assert r.returncode == 0, r.stderr.decode()[-2000:]
        with open(out.name, "rb") as f:
            return pickle.load(f)


# Max |DMPL coefficient| difference between two JAX solves of this problem
# whose observations differ by 1e-7 m (`jax_dmpl_solve(0)` against
# `jax_dmpl_solve(1e-7)`, measured once on the CPU: 0.0134, with the fitted
# markers 0.065 mm apart): the solve's own sensitivity to rounding. The
# port is held to DMPL_FLOOR_FACTOR times it (it measured 0.0060 from the
# JAX solve, each JAX solve taking ~30 s in its subprocess).
DMPL_JAX_FLOOR = 0.0134
DMPL_FLOOR_FACTOR = 2.0


def test_solve_matches_jax(dmpl):
    """(e) the whole CPU solve against the JAX package's: mean marker error
    within 0.1 mm, fitted markers within 0.3 mm, trans within 2 mm (the
    tolerances of tests/test_torch_stageii.py), the DMPL coefficients within
    DMPL_FLOOR_FACTOR times the JAX-vs-JAX floor."""
    fp, (prob, opts, prior) = dmpl
    res = stageii.mosh_stageii_solve(prob, opts, fp["obs"], fp["mask"],
                                     prior=prior, model_type="smplh",
                                     device="cpu")
    assert res.extra.shape == (4, 8)
    ref = jax_dmpl_solve_subprocess()
    err_mm = float(res.data_err.mean()) * 1e3
    assert abs(err_mm - ref["data_err"].mean() * 1e3) < 0.1
    d_sim = np.abs(res.markers_sim.numpy() - ref["markers_sim"]).max() * 1e3
    assert d_sim < 0.3, f"fitted markers moved {d_sim:.4f} mm"
    d_tr = np.abs(res.trans.numpy() - ref["trans"]).max() * 1e3
    assert d_tr < 2.0, f"trans moved {d_tr:.4f} mm"
    d_dmpl = float(np.abs(res.extra.numpy() - ref["extra"]).max())
    assert d_dmpl <= DMPL_FLOOR_FACTOR * DMPL_JAX_FLOOR, d_dmpl
