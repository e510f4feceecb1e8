"""The port's stage-ii residual rows (`make_stageii_residual`) against the
JAX package's, and against the port's own direct system assembly, on the
CPU.

(a) the rows of one frame equal JAX's on the same problem and inputs, to
    1e-5 of max |r|; (b) the port's `make_stageii_system` equals f = rᵀr,
    g = Jᵀr and B = JᵀJ with J from `torch.func.jacfwd` of the port's rows,
    to tests/test_stageii_system.py's bar (f to rtol 1e-5, g and B to
    5e-4 of their largest magnitude); (c) the term energies sum to the
    cost; (d) a 4-frame phase solved through the generic-solver path
    (`_residual_system` of the rows) lands within phase 3's 0.02 mm of the
    same phase solved through the direct assembly.

The cases are tests/test_stageii_system.py's `_setup` (300 vertices, 10
markers, two of them missing, every anchor on): SMPL+H with fingers, 8
DMPLs, an SMPL-X face with 4 expressions, SMPL, MANO, the horse's callable
prior, the dog's GMM on its gathered dofs, and the rigid object. The port's problem is
built from the JAX problem's frozen fields, so both use the same marker
frames.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from moshpp_tpu.models import make_synthetic_model as jax_make_model
from moshpp_tpu.models.body_model import pose_part_ids
from moshpp_tpu.ops.surface import vertex_normals as jax_normals
from moshpp_tpu.pipeline import stageii as jax_stageii
from moshpp_tpu.priors import make_gmm_prior as jax_gmm

from moshpp_torch.pipeline import stageii
from moshpp_torch.priors.gmm import gmm_prior_from_arrays
from moshpp_torch.solver import gauss_newton as gn
from torch_families_common import port_model, port_opts

torch.set_num_threads(1)

ROWS_RTOL = 1e-5          # (a): of max |r|
F_RTOL = 1e-5             # (b), (c): tests/test_stageii_system.py:73
GB_ATOL = 5e-4            # (b): of the largest |g|, |B|
PHASE_MEAN_MM = 0.02      # (d): chip_smoke.py phase 3's mean-error gate

# case: (family, options, synthetic-model knobs, prior)
CASES = {
    "smplh": ("smplh", dict(optimize_fingers=True), dict(dof_per_hand=6),
              "gmm"),
    "dmpl8": ("smplh", dict(optimize_dynamics=True, num_dmpls=8),
              dict(dof_per_hand=6, num_shape_dirs=24), "gmm"),
    "smplx_face4": ("smplx", dict(optimize_fingers=True, optimize_face=True,
                                  num_expressions=4, expr_start=16),
                    dict(dof_per_hand=6, num_shape_dirs=20), "gmm"),
    "smpl": ("smpl", {}, {}, "gmm"),
    "mano": ("mano", {}, dict(dof_per_hand=6), None),
    "horse": ("animal_horse", {}, {}, "callable"),
    "dog": ("animal_dog", {}, {}, "gmm"),
    "object": ("object", {}, None, None),
}


def _object_model():
    """tests/golden_common.py's rigid prop as a one-joint model."""
    from moshpp_tpu.models.object_model import (RigidObjectModel,
                                                object_as_surface_model)
    from moshpp_tpu.models.synthetic import icosphere
    sv, sf = icosphere(2)
    return object_as_surface_model(RigidObjectModel(
        v_template=jnp.asarray(sv * np.array([0.11, 0.07, 0.19]),
                               jnp.float32),
        faces=jnp.asarray(sf, jnp.int32)))


def _priors(family, kind):
    """(JAX prior, the port's prior) of the same function."""
    if kind is None:
        return None, None
    dim = len(pose_part_ids(family, optimize_toes=True)["body"])
    if kind == "callable":
        mean = (np.random.default_rng(0).normal(size=dim) * 0.05).astype(
            np.float32)
        jmean, tmean = jnp.asarray(mean), torch.as_tensor(mean)
        return (lambda pb: (pb - jmean) * 0.8), (lambda pb: (pb - tmean) * 0.8)
    jp = jax_gmm(dim=dim, num_components=3, seed=2, scale=0.3)
    return jp, gmm_prior_from_arrays(np.asarray(jp.means),
                                     np.asarray(jp.chols),
                                     np.asarray(jp.sqrt_neg_log_w),
                                     device="cpu")


def _setup(name, seed=3, markers=10):
    """tests/test_stageii_system.py's `_setup` for case `name`, in both
    packages: (JAX problem, options, prior; the port's problem, options,
    prior; the family; x (D,); aux of one frame as numpy)."""
    family, over, mk, kind = CASES[name]
    rng = np.random.default_rng(seed)
    model = (_object_model() if family == "object" else
             jax_make_model(family, num_verts=300, seed=seed, **mk))
    jopts = jax_stageii.StageIIOptions(**over)
    nb = min(16, model.num_shape_dirs)
    betas = (rng.normal(size=16) * 0.3).astype(np.float32)[:nb]
    if family == "object":
        betas = np.zeros(nb, np.float32)
    can_v = np.asarray(model.v_template) + np.einsum(
        "vcb,b->vc", np.asarray(model.shapedirs)[..., :nb], betas)
    vn = np.asarray(jax_normals(jnp.asarray(can_v), model.faces))
    vids = rng.choice(can_v.shape[0], markers, replace=False)
    latents = can_v[vids] + vn[vids] * 0.0095
    jprob = jax_stageii.prepare_stageii_problem(model, betas, latents,
                                                opts=jopts)
    P = jprob.sub_model.pose_dof
    E = jax_stageii._num_extra(jprob.sub_model, jopts)
    x = (rng.normal(size=(3 + P + E,)) * 0.2).astype(np.float32)
    mask = np.ones(markers, np.float32)
    mask[:2] = 0.0
    aux = {
        "markers": (rng.normal(size=(markers, 3)) * 0.3).astype(np.float32),
        "mask": mask,
        "wt_data": np.float32(3.7),
        "anneal": np.float32(1.4),
        "wt_pose_scale": np.float32(5.0),
        "velo_anchor": (rng.normal(size=P) * 0.1).astype(np.float32),
        "velo_on": np.float32(1.0),
        "extra_anchor": (rng.normal(size=E) * 0.1).astype(np.float32),
        "extra_on": np.float32(1.0 if E else 0.0),
    }
    opts = port_opts(jopts)
    frame_idx = np.stack([np.asarray(c) for c in
                          (jprob.frame_c0, jprob.frame_c1, jprob.frame_c2)], 1)
    prob = stageii.problem_from_arrays(
        port_model(jprob.sub_model), frame_idx, np.asarray(jprob.coeffs),
        np.asarray(jprob.betas), opts, device="cpu")
    jprior, prior = _priors(family, kind)
    return dict(jprob=jprob, jopts=jopts, jprior=jprior, prob=prob,
                opts=opts, prior=prior, family=family, x=x, aux=aux)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return _setup(request.param)


def _rows(c):
    """The port's rows and the port's jacfwd J at the case's point."""
    res = stageii.make_stageii_residual(c["prob"], c["opts"], c["prior"],
                                        c["family"])
    aux = {k: torch.as_tensor(v) for k, v in c["aux"].items()}
    x = torch.as_tensor(c["x"])
    return res(x, aux), torch.func.jacfwd(lambda xx: res(xx, aux))(x)


def test_rows_match_jax(case):
    """(a) the rows, row for row, to 1e-5 of max |r|."""
    jres = jax_stageii.make_stageii_residual(case["jprob"], case["jopts"],
                                             case["jprior"], case["family"])
    ref = np.asarray(jres(jnp.asarray(case["x"]),
                          {k: jnp.asarray(v) for k, v in case["aux"].items()}))
    r, _ = _rows(case)
    assert r.shape == ref.shape
    np.testing.assert_allclose(r.numpy(), ref,
                               atol=ROWS_RTOL * np.abs(ref).max())


def test_system_matches_rows(case):
    """(b) the kernel path's direct assembly against jacfwd of the rows,
    and its cost function against rᵀr."""
    r, J = _rows(case)
    f_ref = float(r @ r)
    g_ref = (J.T @ r).numpy()
    B_ref = (J.T @ J).numpy()
    system = stageii.make_stageii_system(case["prob"], case["opts"],
                                         case["prior"], case["family"])
    x = torch.as_tensor(case["x"])[None]
    aux = {k: torch.as_tensor(v)[None] for k, v in case["aux"].items()}
    f, g, B = system.system_fn(x, aux)
    np.testing.assert_allclose(float(f[0]), f_ref, rtol=F_RTOL)
    np.testing.assert_allclose(g[0].numpy(), g_ref,
                               atol=GB_ATOL * np.abs(g_ref).max())
    np.testing.assert_allclose(B[0].numpy(), B_ref,
                               atol=GB_ATOL * np.abs(B_ref).max())
    np.testing.assert_allclose(float(system.cost_fn(x, aux)[0]), f_ref,
                               rtol=F_RTOL)


def test_term_energies_sum_to_cost(case):
    """(c) the report's terms add up to rᵀr, and are named as JAX names
    them (`report_arrays_spec`)."""
    r, _ = _rows(case)
    en = stageii.stageii_term_energies(case["prob"], case["opts"],
                                       case["prior"], case["family"])(
        torch.as_tensor(case["x"])[None],
        {k: torch.as_tensor(v)[None] for k, v in case["aux"].items()})
    np.testing.assert_allclose(sum(float(v[0]) for v in en.values()),
                               float(r @ r), rtol=F_RTOL)
    assert tuple(en) == stageii.report_arrays_spec(
        case["prob"], case["opts"], case["prior"], case["family"])


def test_generic_solver_phase_matches_direct():
    """(d) a 4-frame step-2 phase of the golden smplh problem, solved from
    the rigid init through `_residual_system(make_stageii_residual(...))`
    and through `make_stageii_system`: their mean marker errors within
    0.02 mm."""
    from golden_common import build_family_problem
    from torch_families_common import port_problem
    fp = dict(build_family_problem("smplh"), family="smplh")
    prob, opts, prior = port_problem(fp)
    obs = torch.as_tensor(fp["obs"])
    maskf = torch.as_tensor(fp["mask"]).to(torch.float32)
    F, M = maskf.shape
    P = prob.sub_model.pose_dof
    n_obs = maskf.sum(1)
    aux = {"markers": obs, "mask": maskf,
           "wt_data": opts.wt("data") * 46.0 / n_obs,
           "anneal": 1.0 + (M - n_obs) / M * opts.wt("annealing"),
           "wt_pose_scale": torch.ones(F),
           "velo_anchor": torch.zeros(F, P), "velo_on": torch.zeros(F)}
    x0 = stageii.rigid_init(prob, opts, obs, maskf)
    _, step2 = stageii._param_masks(prob.sub_model, opts, "smplh", "cpu")
    dl = gn.DoglegOptions(maxiter=40, delta_0=0.5, linear_solver="cholesky")
    generic = gn._residual_system(
        stageii.make_stageii_residual(prob, opts, prior, "smplh"),
        batched_aux=True)
    direct = stageii.make_stageii_system(prob, opts, prior, "smplh")
    errs = []
    with gn.fp32_matmul():
        for system in (generic, direct):
            res = gn.batched_system_solve(system, x0, aux, dl,
                                          param_mask=step2, e_3=1e-4,
                                          compact_buckets=())
            sim = stageii.simulate_markers(prob, opts, res.x)
            d = torch.linalg.vector_norm(sim - obs, dim=-1) * maskf
            errs.append(float((d.sum(1) / n_obs).mean()) * 1e3)
    assert np.isfinite(errs).all()
    assert abs(errs[0] - errs[1]) <= PHASE_MEAN_MM, errs
