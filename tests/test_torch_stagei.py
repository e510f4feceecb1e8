"""The port's stage i against the JAX package, on the CPU.

On tests/golden_common.py's stage-i problem (SMPL+H, 642 vertices, 10
markers, 3 frames), from the same numpy inputs:
(a) the context and initial state, the frozen structure of an annealing
    step (candidate faces as sets, swaps only at the last rank), the free
    masks bit for bit, the step residual against JAX and the committed
    golden probe, and its Jacobian against JAX's jacfwd; the same residual
    with the fingers free, with the SMPL-X face free and with head markers;
(b) the residual-driven dogleg solves against JAX's on a small nonlinear
    least-squares problem: the same iterations;
(c) the single and the batched solve against live JAX solves, and the
    single solve chained into stage ii against the JAX chain;
(d) the batched solve's restrictions (ValueError), the device check, and
    the layout and frame helpers.

The JAX solves run in a fresh interpreter started as this module begins
(tests/torch_stagei_common.py).
"""

import dataclasses
import os
from collections import OrderedDict

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from golden_common import build_stagei_problem
from torch_families_common import port_model
from torch_stagei_common import (CHAIN_OPTS, batched_stagei_problem,
                                 port_inputs, start_jax_runs)
from moshpp_tpu.markers.layout import layout_arrays as jax_layout_arrays
from moshpp_tpu.models import make_synthetic_model as jax_synthetic_model
from moshpp_tpu.ops.marker_transform import (
    select_frame_indices as jax_select_frame_indices)
from moshpp_tpu.pipeline import stagei as jstagei
from moshpp_tpu.pipeline.frame_picker import (
    frames_to_arrays as jax_frames_to_arrays)
from moshpp_tpu.solver import gauss_newton as jgn

from moshpp_torch.markers.layout import layout_arrays
from moshpp_torch.pipeline import stagei, stageii
from moshpp_torch.pipeline.frame_picker import frames_to_arrays
from moshpp_torch.solver import gauss_newton as tgn

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_goldens.py's probe tolerance and stage-i outcome bars (mm)
PROBE_TOL = 2e-4
MEAN_MM, LATENT_MM = 0.1, 0.5
# the chain's bar: the mean marker error of stage ii (mm)
CHAIN_MM = 0.1
FLOOR_FACTOR = 1.5
# The JAX solve's own deviation under 1e-7 m of observation noise, the
# largest over ten seeds (tools/stagei_floor.py on the CPU): the
# mean data error and the latent markers of the single solve and of the
# batched subjects, and the chain's mean marker error, in mm. The 10-marker,
# 3-frame problem leaves most of its 289 unknowns to the prior and the
# anchors, so rounding moves the stopping point further than the fixed bars.
FLOOR_SINGLE_ERR_MM = 0.1526
FLOOR_SINGLE_LAT_MM = 1.0135
FLOOR_BATCHED_ERR_MM = 0.6101
FLOOR_BATCHED_LAT_MM = 3.3914
FLOOR_CHAIN_MM = 0.0540
# the step residual and Jacobian against JAX: the residual at the probe
# tolerance, each Jacobian column within 1e-4 of its largest entry
JAC_TOL = 1e-4
# candidate faces may differ only where rounding swaps a near-tie at the
# last rank: squared distances within this of the last kept one (m^2)
SWAP_GAP_M2 = 1e-10
# a marker's frame vertices may differ from JAX's only at near-ties: JAX's
# squared distances (float64) of the two vertices within this (m^2)
TIE_GAP_M2 = 1e-6


@pytest.fixture(scope="module", autouse=True)
def jax_runs(tmp_path_factory):
    result, stop = start_jax_runs(tmp_path_factory.mktemp("stagei"))
    yield result
    stop()


@pytest.fixture(scope="module")
def problem():
    """(the JAX problem, the port's inputs, the port's context and state)."""
    sp = build_stagei_problem()
    pi = port_inputs(sp)
    ctx, state = stagei.prepare_stagei_context(
        pi["model"], **pi["kwargs"], opts=pi["opts"], prior=pi["prior"],
        device="cpu")
    return sp, pi, ctx, state


@pytest.fixture(scope="module")
def port_single(problem):
    sp, pi, _, _ = problem
    return stagei.mosh_stagei_solve(
        pi["model"], latent_labels=sp["labels"], **pi["kwargs"],
        opts=pi["opts"], prior=pi["prior"], device="cpu")


def np_(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def test_context_matches_jax(problem):
    """The initial state and every array of the context."""
    sp, _, ctx, state = problem
    jctx, jstate = sp["ctx"], sp["state"]
    for name, a, b in zip(("betas", "latents", "poses", "trans", "exprs"),
                          state, jstate):
        np.testing.assert_allclose(np_(a), np_(b), atol=1e-6, err_msg=name)
    for name in ("exclude_vertex_mask", "prior_ids"):
        np.testing.assert_array_equal(np_(getattr(ctx, name)),
                                      np_(getattr(jctx, name)), name)
    for name in ("frames_obs", "maskf", "m2b_j", "init_anchor",
                 "init_wt_type"):
        np.testing.assert_allclose(np_(getattr(ctx, name)),
                                   np_(getattr(jctx, name)), atol=1e-7,
                                   err_msg=name)
    for name in ("lay", "parts", "base_wt_data", "head_corr_mat", "head_ids"):
        assert getattr(ctx, name) == getattr(jctx, name), name
    assert ctx.face_ids == list(jctx.face_ids)
    np.testing.assert_array_equal(ctx.faces_np, jctx.faces_np)


def test_frozen_structure_matches_jax(problem):
    """The frame triples and unions exactly; the candidate faces as sets,
    a face swapped only for a near-tie at the last rank."""
    sp, _, ctx, state = problem
    jctx, jstate = sp["ctx"], sp["state"]
    fz = stagei._freeze_stagei_structure(ctx, state[0], state[1])
    jfz = jstagei._freeze_stagei_structure(jctx, jstate[0], jstate[1])
    can_v = jstagei._full_can_verts(jctx.model, jstate[0])
    jidx = jax_select_frame_indices(can_v, jstate[1], k=jctx.opts.knn_k,
                                    exclude_mask=jctx.exclude_vertex_mask)
    np.testing.assert_array_equal(np_(fz["frame_vids"]), np_(jidx.stacked))
    # JAX's candidates by their corners' template positions
    v = np_(jctx.model.v_template)
    face_of = {v[f].tobytes(): i for i, f in enumerate(ctx.faces_np)}
    jcorners = np_(jfz.can_template)[np_(jfz.cand_local)]      # (M, K, 3, 3)
    jcand = np.array([[face_of[c.tobytes()] for c in m] for m in jcorners])
    d = np_(stagei._face_sq_distances(stagei._full_can_verts(
        ctx.model, state[0]), ctx.model.faces, state[1]))
    cand = np_(fz["cand_faces"])
    K = cand.shape[1]
    for m in range(cand.shape[0]):
        ours, theirs = set(cand[m]), set(jcand[m])
        if ours == theirs:
            continue
        last = np.sort(d[m])[K - 1]
        for f in ours ^ theirs:
            assert abs(d[m, f] - last) <= SWAP_GAP_M2, (m, f, d[m, f], last)
    same = all(set(a) == set(b) for a, b in zip(cand, jcand))
    if same:
        for name, ours, theirs in (
                ("idx_can", fz["idx_can"], jfz.idx_can.stacked),
                ("idx_posed", fz["idx_posed"], jfz.idx_posed.stacked),
                ("can_template", fz["can_template"], jfz.can_template),
                ("can_shapedirs", fz["can_shapedirs"], jfz.can_shapedirs),
                ("v_template", fz["v_template"], jfz.sub_model.v_template),
                ("posedirs", fz["posedirs"], jfz.sub_model.posedirs),
                ("weights", fz["weights"], jfz.sub_model.weights)):
            np.testing.assert_array_equal(np_(ours), np_(theirs), name)
    # the sign normals at each candidate's corners
    order = [np.argsort(c) for c in cand]
    jorder = [np.argsort(c) for c in jcand]
    for m in range(cand.shape[0]):
        if set(cand[m]) == set(jcand[m]):
            np.testing.assert_allclose(
                np_(fz["vn_corners"])[m][order[m]],
                np_(jfz.vn_corners)[m][jorder[m]], atol=1e-6)


@pytest.mark.parametrize("detailed", [False, True])
def test_pmask_bit_for_bit(problem, detailed):
    sp, _, ctx, _ = problem
    np.testing.assert_array_equal(stagei._stagei_pmask(ctx, detailed),
                                  jstagei._stagei_pmask(sp["ctx"], detailed))


def _step_pair(jctx, jstate, ctx, state, anneal, detailed, x_shift=None):
    """The JAX and the port's step residual and Jacobian at the packed init
    state (moved by x_shift)."""
    jr, _ = jstagei.build_stagei_step(jctx, jstate[0], jstate[1], anneal,
                                      detailed)
    tr, _ = stagei.build_stagei_step(ctx, state[0], state[1], anneal,
                                     detailed)
    ne = jctx.lay.ne
    xj = jctx.lay.pack(*jstate[:4], jstate[4] if ne else None)
    xt = ctx.lay.pack(*state)
    if x_shift is not None:
        xj, xt = xj + jnp.asarray(x_shift), xt + torch.as_tensor(x_shift)
    rj, rt = np.asarray(jax.jit(jr)(xj)), np_(tr(xt))
    Jj = np.asarray(jax.jit(jax.jacfwd(jr))(xj))
    Jt = np_(torch.func.jacfwd(tr)(xt))
    return rj, rt, Jj, Jt


def _check_step(rj, rt, Jj, Jt, what):
    assert rt.shape == rj.shape, what
    np.testing.assert_allclose(rt, rj,
                               atol=PROBE_TOL * max(np.abs(rj).max(), 1.0),
                               err_msg=what)
    assert np.isfinite(Jt).all(), what
    col = np.maximum(np.abs(Jj).max(0), 1e-12)
    err = (np.abs(Jt - Jj) / col).max()
    assert err <= JAC_TOL, (what, err)


@pytest.mark.parametrize("anneal,detailed", [(1.0, False), (0.25, True)])
def test_step_residual_and_jacobian_match_jax(problem, anneal, detailed):
    sp, _, ctx, state = problem
    _check_step(*_step_pair(sp["ctx"], sp["state"], ctx, state, anneal,
                            detailed), f"anneal {anneal}")


def test_step_residual_matches_golden_probe(problem):
    """tests/test_goldens.py's probe: the detailed step at anneal 1 at the
    init state, at its tolerance."""
    _, _, ctx, state = problem
    tr, _ = stagei.build_stagei_step(ctx, state[0], state[1], 1.0, True)
    r = np_(tr(ctx.lay.pack(*state)))
    ref = np.load(os.path.join(REPO, "tests", "goldens",
                               "stagei_smplh.npz"))["probe"]
    assert r.shape == ref.shape
    np.testing.assert_allclose(r, ref,
                               atol=PROBE_TOL * max(np.abs(ref).max(), 1.0))


def _variant(kind):
    """(JAX ctx and state, the port's) for the golden problem with the
    fingers free, a small SMPL-X with the face free, or head markers."""
    sp = build_stagei_problem()
    kw = dict(sp["kwargs"])
    model = sp["model"]
    extra = {}
    if kind == "fingers":
        kw["opts"] = dataclasses.replace(kw["opts"], optimize_fingers=True)
    elif kind == "face":
        model = jax_synthetic_model("smplx", num_verts=300, seed=9,
                                    dof_per_hand=6, num_shape_dirs=20)
        kw["opts"] = dataclasses.replace(kw["opts"], optimize_face=True,
                                         num_expressions=4, expr_start=16)
        F, M = kw["frames_mask"].shape
        rng = np.random.default_rng(4)
        kw["layout_vids"] = rng.choice(model.v_template.shape[0], M,
                                       replace=False)
        kw["frames_obs"] = (np.asarray(model.v_template)[kw["layout_vids"]]
                            + rng.normal(size=(F, M, 3)) * 0.02).astype(
                                np.float32)
    elif kind == "head":
        rng = np.random.default_rng(6)
        a = rng.normal(size=(3, 3))
        extra["head_corr"] = ((a @ a.T + 3 * np.eye(3)).astype(np.float32),
                              np.array([1, 4, 7]))
    jctx, jstate = jstagei.prepare_stagei_context(model, **kw, **extra)
    pi = port_inputs(dict(sp, kwargs=kw))
    ctx, state = stagei.prepare_stagei_context(
        port_model(model), **pi["kwargs"], opts=pi["opts"],
        prior=pi["prior"], device="cpu", **extra)
    return jctx, jstate, ctx, state


@pytest.mark.parametrize("kind", ["fingers", "face", "head"])
def test_variant_residual_and_jacobian_match_jax(kind):
    """The detailed step (finger, jaw and expression rows where free; the
    head markers' correlated anchor rows), at the init state and at a
    moved point where the expressions are nonzero."""
    jctx, jstate, ctx, state = _variant(kind)
    shift = (np.random.default_rng(2).normal(size=ctx.lay.dim) * 0.01
             ).astype(np.float32)
    for x_shift in (None, shift):
        _check_step(*_step_pair(jctx, jstate, ctx, state, 0.5, True,
                                x_shift), kind)
    assert np.array_equal(stagei._stagei_pmask(ctx, True),
                          jstagei._stagei_pmask(jctx, True))


def test_batched_system_matches_single(problem):
    """The batched system over stacked frozen structures of different
    vertex unions (zero-padded rows) equals each subject's own system:
    f, g = Jᵀr and B = JᵀJ within 1e-5 of their largest magnitude."""
    _, _, ctx, state = problem
    moved = state[1] + torch.as_tensor(np.random.default_rng(3).normal(
        size=tuple(state[1].shape)) * 5e-3, dtype=torch.float32)
    fzs = [stagei._freeze_stagei_structure(ctx, state[0], lat)
           for lat in (state[1], moved)]
    sizes = {k: [fz[k].shape[0] for fz in fzs]
             for k in ("can_template", "v_template")}
    assert any(a != b for a, b in sizes.values()), sizes
    rf = stagei._stagei_residual_fn(ctx, 0.5, True)
    x = torch.stack([ctx.lay.pack(*state)] * 2)
    x[1] += torch.as_tensor(np.random.default_rng(4).normal(
        size=ctx.lay.dim) * 1e-3, dtype=torch.float32)
    batched = tgn._residual_system(rf, True).system_fn(
        x, stagei._stack_frozen(fzs))
    for s, fz in enumerate(fzs):
        single = tgn._residual_system(lambda xx, _: rf(xx, fz),
                                      False).system_fn(x[s:s + 1], None)
        for name, b, one in zip("fgB", batched, single):
            np.testing.assert_allclose(
                np_(b[s]), np_(one[0]),
                atol=1e-5 * float(one.abs().max()), err_msg=f"{s} {name}")


def _lsq_problem():
    rng = np.random.default_rng(0)
    D, R, S = 6, 14, 3
    A = rng.normal(size=(R, D)).astype(np.float32)
    b = rng.normal(size=(S, R)).astype(np.float32)
    x0 = (rng.normal(size=(S, D)) * 0.5).astype(np.float32)
    mask = np.ones(D, np.float32)
    mask[2] = 0.0
    return A, b, x0, mask


def test_dogleg_matches_jax():
    """dogleg_solve and batched_dogleg_solve on a nonlinear least-squares
    problem with a frozen parameter: the same iterations, x within 1e-5."""
    A, b, x0, mask = _lsq_problem()
    At = torch.as_tensor(A)
    rj = lambda x, bb: jnp.concatenate([jnp.sin(A @ x) - bb,
                                        0.3 * x ** 2 - 0.1])
    rt = lambda x, bb: torch.cat([torch.sin(At @ x) - bb, 0.3 * x ** 2 - 0.1])
    for maxiter in (1, 3, 100):
        jo = jgn.DoglegOptions(maxiter=maxiter, e_3=1e-3)
        to = tgn.DoglegOptions(maxiter=maxiter, e_3=1e-3)
        ref = jax.jit(lambda xx: jgn.dogleg_solve(
            lambda x: rj(x, b[0]), xx, jo, param_mask=jnp.asarray(mask)))(
                jnp.asarray(x0[0]))
        out = tgn.dogleg_solve(lambda x: rt(x, torch.as_tensor(b[0])),
                               torch.as_tensor(x0[0]), to,
                               param_mask=torch.as_tensor(mask))
        assert int(out.iterations) == int(ref.iterations), maxiter
        np.testing.assert_allclose(np_(out.x), np.asarray(ref.x), atol=1e-5)
        assert out.x[2] == float(x0[0, 2])
    jo = jgn.DoglegOptions(maxiter=50, e_3=1e-3)
    ref = jax.jit(lambda xx, a: jgn.batched_dogleg_solve(
        lambda x, aa: rj(x, aa["b"]), xx, a, jo,
        param_mask=jnp.asarray(mask)))(jnp.asarray(x0),
                                       {"b": jnp.asarray(b)})
    out = tgn.batched_dogleg_solve(
        lambda x, aa: rt(x, aa["b"]), torch.as_tensor(x0),
        {"b": torch.as_tensor(b)}, tgn.DoglegOptions(maxiter=50, e_3=1e-3),
        param_mask=torch.as_tensor(mask))
    np.testing.assert_array_equal(np_(out.iterations),
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(np_(out.x), np.asarray(ref.x), atol=1e-5)
    assert out.host_syncs == int(out.iterations.max()) + 1


def _gate(bar, floor):
    return max(bar, FLOOR_FACTOR * floor)


def _deviation(res, ref):
    """(mean data error difference, latents' largest difference), mm."""
    return (abs(res.errs["data_mean_m"] - ref["errs"]["data_mean_m"]) * 1e3,
            float(np.abs(np_(res.markers_latent)
                         - ref["markers_latent"]).max()) * 1e3)


def test_solve_matches_jax(problem, port_single, jax_runs):
    """The single solve against the live JAX solve: the mean data error
    within max(0.1 mm, 1.5 x the JAX floor), the latents within max(0.5
    mm, 1.5 x its floor)."""
    sp, _, ctx, _ = problem
    res = port_single
    F, M = ctx.lay.F, ctx.lay.M
    assert res.markers_sim.shape == (F, M, 3)
    assert len(res.iterations) == 4 and res.host_syncs > 0
    assert list(res.markers_latent_vids) == sp["labels"]
    d_err, d_lat = _deviation(res, jax_runs("single")["single"])
    assert d_err <= _gate(MEAN_MM, FLOOR_SINGLE_ERR_MM), d_err
    assert d_lat <= _gate(LATENT_MM, FLOOR_SINGLE_LAT_MM), d_lat


def test_solve_batched_matches_jax(problem, port_single, jax_runs):
    """The batched solve of two subjects against the JAX batched solve, at
    the single solve's gates with the batched floor; subject 0 also against
    the port's single solve of the same frames by tests/test_pipeline.py's
    bar (its mean data error below max(2 x the single's, 4 mm))."""
    sp, pi, _, _ = problem
    bp = batched_stagei_problem(sp)
    kw = pi["kwargs"]
    res = stagei.mosh_stagei_solve_batched(
        pi["model"], bp["frames_obs"], bp["frames_mask"], sp["labels"],
        kw["layout_vids"], kw["m2b"], kw["type_masks"], opts=pi["opts"],
        prior=pi["prior"], device="cpu")
    assert len(res) == len(bp["frames_obs"])
    for r, ref in zip(res, jax_runs("batched")["batched"]):
        d_err, d_lat = _deviation(r, ref)
        assert d_err <= _gate(MEAN_MM, FLOOR_BATCHED_ERR_MM), d_err
        assert d_lat <= _gate(LATENT_MM, FLOOR_BATCHED_LAT_MM), d_lat
    single = port_single.errs["data_mean_m"]
    assert res[0].errs["data_mean_m"] < max(2.0 * single, 4e-3)


def _stageii_err(model, prior, res, sp):
    o2 = stageii.StageIIOptions(**CHAIN_OPTS)
    prob = stageii.prepare_stageii_problem(model, res.betas,
                                           res.markers_latent, o2,
                                           device="cpu")
    kw = sp["kwargs"]
    out = stageii.mosh_stageii_solve(prob, o2, kw["frames_obs"],
                                     kw["frames_mask"], prior=prior,
                                     model_type="smplh", device="cpu")
    return float(out.data_err.mean()) * 1e3


def test_chain_matches_jax(problem, port_single, jax_runs):
    """The port's stage i chained into the port's stage ii against the JAX
    chain: the mean marker error within max(0.1 mm, 1.5 x the chain's
    floor); and the JAX stage i carried into the port's stage ii
    (`stagei_result_from_arrays`) within 0.1 mm of the JAX chain."""
    sp, pi, _, _ = problem
    runs = jax_runs("single")
    ref_mm = float(runs["chain_err"].mean()) * 1e3
    ours = _stageii_err(pi["model"], pi["prior"], port_single, sp)
    assert abs(ours - ref_mm) <= _gate(CHAIN_MM, FLOOR_CHAIN_MM), (ours,
                                                                   ref_mm)
    carried = stagei.stagei_result_from_arrays(runs["single"], device="cpu")
    assert carried.latent_labels == sp["labels"]
    mixed = _stageii_err(pi["model"], pi["prior"], carried, sp)
    assert abs(mixed - ref_mm) <= CHAIN_MM, (mixed, ref_mm)


@pytest.mark.parametrize("field", ["lay", "opts", "init_anchor",
                                   "init_wt_type", "m2b_j", "prior",
                                   "base_wt_data"])
def test_batched_checks_shared_fields(problem, field):
    """Quirk A: the batched solve builds one residual from the first
    subject, so a subject whose shared field differs raises, naming it."""
    _, pi, ctx, _ = problem
    moved = {
        "lay": lambda v: v._replace(F=v.F + 1),
        "opts": lambda v: dataclasses.replace(v, surf_candidates=16),
        "prior": lambda v: dataclasses.replace(v, means=v.means + 1.0),
        "base_wt_data": lambda v: v * 2.0,
    }.get(field, lambda v: v + 1.0)
    other = ctx._replace(**{field: moved(getattr(ctx, field))})
    stagei._check_shared([ctx, ctx])
    with pytest.raises(ValueError, match=field):
        stagei._check_shared([ctx, other])


def test_batched_needs_one_layout_and_frame_count(problem):
    """Quirk B: subjects of other frame counts or marker counts raise."""
    sp, pi, _, _ = problem
    kw = pi["kwargs"]
    obs, mask = kw["frames_obs"], kw["frames_mask"]
    args = (sp["labels"], kw["layout_vids"], kw["m2b"], kw["type_masks"])
    for o, m in (([obs, obs[:2]], [mask, mask[:2]]),
                 ([obs, obs[:, :9]], [mask, mask[:, :9]]),
                 (obs[None, :, :9], mask[None, :, :9])):
        with pytest.raises(ValueError, match="All subjects must share one "
                           "layout and one frame count"):
            stagei.mosh_stagei_solve_batched(pi["model"], o, m, *args,
                                             opts=pi["opts"],
                                             prior=pi["prior"], device="cpu")


def test_device_must_hold_model_and_prior(problem):
    sp, pi, _, _ = problem
    kw = pi["kwargs"]
    with pytest.raises(ValueError, match="model"):
        stagei.mosh_stagei_solve(pi["model"].to("meta"), latent_labels=
                                 sp["labels"], **kw, opts=pi["opts"],
                                 prior=pi["prior"], device="cpu")
    prior = pi["prior"]
    elsewhere = dataclasses.replace(prior, **{
        f.name: getattr(prior, f.name).to("meta")
        for f in dataclasses.fields(prior)})
    with pytest.raises(ValueError, match="prior"):
        stagei.prepare_stagei_context(pi["model"], **kw, opts=pi["opts"],
                                      prior=elsewhere, device="cpu")


def test_layout_and_frames_match_jax():
    """layout_arrays on a layout of two marker types (one marker with a
    vertex list) and frames_to_arrays with missing and NaN markers."""
    meta = {
        "marker_vids": OrderedDict([("A", 10), ("B", [20, 21]), ("C", 30),
                                    ("D", 40)]),
        "marker_type_mask": OrderedDict([
            ("body", np.array([1, 1, 0, 0], bool)),
            ("finger", np.array([0, 0, 1, 0], bool))]),
        "m2b_distance": OrderedDict([("body", 0.0095), ("finger", 0.005)]),
    }
    ref, out = jax_layout_arrays(meta), layout_arrays(meta)
    assert out["labels"] == ref["labels"]
    for k in ("vids", "m2b"):
        np.testing.assert_array_equal(out[k], ref[k])
        assert out[k].dtype == ref[k].dtype
    assert out["type_masks"].keys() == ref["type_masks"].keys()
    for k in ref["type_masks"]:
        np.testing.assert_array_equal(out["type_masks"][k],
                                      ref["type_masks"][k])
    frames = [{"A": np.ones(3), "B": np.array([np.nan, 0, 0]),
               "C": np.zeros(3)}, {"D": np.arange(3.0), "E": np.ones(3)}]
    labels = ["A", "B", "C", "D"]
    for o, r in zip(frames_to_arrays(frames, labels),
                    jax_frames_to_arrays(frames, labels)):
        np.testing.assert_array_equal(o, r)


def test_chip_smoke_world_matches_bench_stagei():
    """chip_smoke.stagei_world, the port's copy of tools/bench_stagei.py's
    `_make_world`, gives the tool's arrays on the same seeds at full width
    (dof_per_hand=24, 16 betas, 46 markers, 12 frames; 642 vertices): the
    layout vertices, betas and motion exactly, the latent markers within
    1e-6 m (float32 rounding of coordinates ~1 m). Each marker's frame
    vertices, chosen by each package on its own canonical vertices, agree
    but where JAX's squared distances of the swapped vertices lie within
    TIE_GAP_M2 (the float32 resolution of |q|^2 - 2 q.p + |p|^2 at ~1 m;
    the icosphere's symmetry makes such near-ties common); the observations
    of the markers whose frames agree within 1e-5 m (the posed vertices
    agree within 3e-7 m, and a marker's local frame amplifies that ~20x)."""
    import argparse
    import sys
    sys.path[:0] = [REPO, os.path.join(REPO, "tools")]
    import chip_smoke
    from bench_stagei import _make_world
    from moshpp_tpu.priors import make_gmm_prior as jax_gmm_prior
    from moshpp_torch.models import make_synthetic_model
    from moshpp_torch.ops.marker_transform import select_frame_indices
    from moshpp_torch.priors.gmm import make_gmm_prior

    kw = dict(num_verts=642, seed=3, dof_per_hand=24)
    jmodel = jax_synthetic_model("smplh", **kw)
    jprior = jax_gmm_prior(dim=63, num_components=8, seed=1, scale=0.3)
    model = make_synthetic_model("smplh", device="cpu", **kw)
    prior = make_gmm_prior(dim=63, num_components=8, seed=1, scale=0.3,
                           device="cpu")
    for seed in (0, 2, 5, 7):
        ref = _make_world(argparse.Namespace(
            frames=12, markers=chip_smoke.MARKERS, seed=seed), jmodel,
            jprior, jnp, jax)
        out = chip_smoke.stagei_world(seed, 12, model, prior)
        for k in ("vids", "betas", "poses", "trans"):
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
        np.testing.assert_allclose(out["latents"], ref["latents"], rtol=0,
                                   atol=1e-6)
        can_j = np.asarray(jmodel.v_template) + np.einsum(
            "vcb,b->vc", np.asarray(jmodel.shapedirs)[..., :16], ref["betas"])
        idx_j = np.asarray(jax_select_frame_indices(
            jnp.asarray(can_j), jnp.asarray(ref["latents"])).stacked)
        can_t = model.v_template + torch.einsum(
            "vcb,b->vc", model.shapedirs[..., :16],
            torch.as_tensor(out["betas"]))
        idx_t = select_frame_indices(
            can_t, torch.as_tensor(out["latents"])).stacked.numpy()
        same = (idx_j == idx_t).all(1)
        d64 = lambda m, v: float(np.sum(
            (can_j[v].astype(np.float64) - ref["latents"][m]) ** 2))
        for m in np.where(~same)[0]:
            for a, b in zip(idx_j[m], idx_t[m]):
                assert abs(d64(m, a) - d64(m, b)) <= TIE_GAP_M2, (
                    seed, m, idx_j[m], idx_t[m])
        assert out["obs"].shape == ref["obs"].shape
        np.testing.assert_allclose(out["obs"][:, same], ref["obs"][:, same],
                                   rtol=0, atol=1e-5)
