"""The SMAL horse, the SMAL dog and a rigid object's stage-ii solves in
the port against the JAX package, on the CPU: a callable prior (the
horse), a GMM on a gathered 93-of-105-dof slice (the dog), one joint with
zero-width posedirs and no prior (the object).

(a) the batched Gauss-Newton system (f, g, B) and the trial-point cost at
    probe points of each family's `golden_common` problem against the JAX
    `make_stageii_system`, and the horse's Mahalanobis-plus-leg-bend prior
    (`mahalanobis.horse_prior`) against the JAX head's;
(b) the full CPU solve against a live JAX solve of the same problem, at
    tests/test_goldens.py's outcome tolerances where the JAX solve itself
    holds them against its own solves with 1e-7 m of observation noise
    (`torch_families_common.check_solve`);
(c) the step masks, the rigid init, the anchor interpolation and the
    outputs (`_finalize`) against the JAX functions.

The JAX solves run in fresh interpreters, one a family, started as this
module begins so they run beside its tests.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from moshpp_tpu.pipeline import stageii as jax_stageii
from moshpp_tpu.priors.mahalanobis import (
    MahalanobisPrior as JaxMahalanobis,
    horse_joint_angle_residual as jax_leg_rows,
    mahalanobis_residual as jax_mahalanobis)

from moshpp_torch.pipeline import stageii
from moshpp_torch.priors.mahalanobis import (horse_prior,
                                             mahalanobis_prior_from_arrays)
from torch_families_common import (build_problems, check_solve,
                                   check_system, start_jax_solves)

torch.set_num_threads(1)

FAMILIES = ("animal_horse", "animal_dog", "object")


@pytest.fixture(scope="module")
def problems():
    return build_problems(FAMILIES)


@pytest.fixture(scope="module", autouse=True)
def jax_solves(tmp_path_factory):
    result, stop = start_jax_solves(FAMILIES,
                                    tmp_path_factory.mktemp("animals"))
    yield result
    stop()


@pytest.mark.parametrize("family", FAMILIES)
def test_system_matches_jax(problems, family):
    """(a) at four probe points, with anneal, prior scale and anchors varied
    per frame; the dog's prior slice is gathered, the horse's a range."""
    fp, (prob, opts, prior) = problems[family]
    spec = stageii._term_spec(prob, opts, family)
    if family == "animal_dog":
        assert spec.body_rng is None and len(spec.body_ids) == 93
    elif family == "animal_horse":
        assert spec.body_rng == (6, 87)
    else:
        assert spec.body_ids is None and prior is None
    check_system(fp, prob, opts, prior, fp["prior"], family)


def test_horse_prior_system_matches_jax(problems):
    """(a) the horse with the head's prior: Mahalanobis rows and 2x the
    leg-bend rows, built by `horse_prior` and by the JAX head's code
    (moshpp_tpu/pipeline/head.py:187-192) from the same arrays."""
    fp, (prob, opts, _) = problems["animal_horse"]
    rng = np.random.default_rng(5)
    mean = (rng.normal(size=81) * 0.1).astype(np.float32)
    a = rng.normal(size=(81, 81)) * 0.1
    prec = (np.linalg.cholesky(np.linalg.inv(0.04 * (np.eye(81) + a @ a.T)))
            ).astype(np.float32)
    jhorse = JaxMahalanobis(mean=jnp.asarray(mean), prec=jnp.asarray(prec))

    def jprior(pose_body):
        return jnp.concatenate([jax_mahalanobis(jhorse, pose_body),
                                2.0 * jax_leg_rows(pose_body)])

    prior = horse_prior(mahalanobis_prior_from_arrays(mean, prec,
                                                      device="cpu"))
    xb = rng.normal(size=81).astype(np.float32) * 0.3
    np.testing.assert_allclose(prior(torch.as_tensor(xb)).numpy(),
                               np.asarray(jprior(jnp.asarray(xb))),
                               rtol=1e-5, atol=1e-5)
    check_system(fp, prob, opts, prior, jprior, "animal_horse")


@pytest.mark.parametrize("family", FAMILIES)
def test_solve_matches_jax(problems, jax_solves, family):
    """(b)"""
    check_solve(problems, jax_solves, family)


@pytest.mark.parametrize("family", FAMILIES)
def test_schedule_pieces_match_jax(problems, family):
    """(c) the step masks, the rigid init, the anchor interpolation and the
    outputs of each family against the JAX functions: the horse's tail,
    mouth and ear dofs (84-107) and the dog's unselected joints stay
    frozen."""
    fp, (prob, opts, _) = problems[family]
    jp, jo = fp["prob"], fp["opts"]
    masks = stageii._param_masks(prob.sub_model, opts, family, "cpu")
    jmasks = jax_stageii._param_masks(jp.sub_model, jo, family)
    for a, b in zip(masks, jmasks):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    step2 = masks[1].numpy()
    if family == "animal_horse":
        assert not step2[3 + 84:].any() and step2[3 + 3:3 + 84].all()
    if family == "animal_dog":
        frozen = [j for j in range(35) if j not in
                  (0, 1, 3, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
                   19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 30, 31, 32, 33, 34)]
        assert frozen == [2, 6, 29]
        assert not step2[[3 + 3 * j + c for j in frozen for c in range(3)]].any()
    if family == "object":
        np.testing.assert_array_equal(step2, np.ones(6, np.float32))

    mask = fp["mask"].astype(np.float32)
    x0 = stageii.rigid_init(prob, opts, torch.as_tensor(fp["obs"]),
                            torch.as_tensor(mask))
    jx0 = jax_stageii.rigid_init(jp, jo, jnp.asarray(fp["obs"]),
                                 jnp.asarray(mask))
    np.testing.assert_allclose(x0.numpy(), np.asarray(jx0), atol=2e-5)

    rng = np.random.default_rng(3)
    xa = (rng.normal(size=(3, x0.shape[1])) * 0.5).astype(np.float32)
    lo, hi = np.asarray([0, 0, 1, 1, 2]), np.asarray([1, 1, 2, 2, 2])
    alpha = np.asarray([0.0, 0.3, 0.5, 0.9, 1.0], np.float32)
    xi = stageii._interp_x(torch.as_tensor(xa), torch.as_tensor(lo),
                           torch.as_tensor(hi), torch.as_tensor(alpha),
                           prob.sub_model)
    jxi = jax_stageii._interp_x(jnp.asarray(xa), jnp.asarray(lo),
                                jnp.asarray(hi), jnp.asarray(alpha),
                                jp.sub_model)
    np.testing.assert_allclose(xi.numpy(), np.asarray(jxi), atol=1e-5)

    # the outputs of a solution: fitted markers, full pose, data error
    x = torch.as_tensor(xi.numpy()[:, :x0.shape[1]])
    iters = torch.arange(5, dtype=torch.int32)
    obs = np.concatenate([fp["obs"], fp["obs"][:1]])
    maskf = np.concatenate([mask, mask[:1]])
    out = stageii._finalize(prob, opts, x, iters, torch.as_tensor(obs),
                            torch.as_tensor(maskf), 7)
    jout = jax_stageii._finalize(jp, jo, jnp.asarray(x.numpy()),
                                 jnp.asarray(iters.numpy()),
                                 jnp.asarray(obs), jnp.asarray(maskf))
    assert out.host_syncs == 7
    for f in jax_stageii.StageIIResult._fields:
        np.testing.assert_allclose(getattr(out, f).numpy(),
                                   np.asarray(getattr(jout, f)), atol=2e-5,
                                   err_msg=f)
