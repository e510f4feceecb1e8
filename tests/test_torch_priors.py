"""The port's prior loaders and animal priors against the JAX package, on
the CPU: `load_gmm_prior` in its four file formats, `sample_gmm_prior`,
`save_gmm_prior_pkl`, `gmm_moments`, the horse's Mahalanobis prior and leg-bend rows, the
dog's prior and pose subset, and the graphical-lasso prior and its subject
cache (the shrinkage path). Every file is written by the test itself from
numpy draws; all to 1e-6 relative.
"""

import pickle
import types

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from moshpp_tpu.priors import gm_prior as jax_gm
from moshpp_tpu.priors import gmm as jax_gmm
from moshpp_tpu.priors import mahalanobis as jax_mh

from moshpp_torch.models.body_model import pose_part_ids
from moshpp_torch.priors import gm_prior, gmm, mahalanobis

RTOL = 1e-6


def _moments(dim=12, K=4, seed=0):
    """Mixture moments like the reference's pose prior: means near zero,
    well-conditioned covariances, Dirichlet weights."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(K, dim)) * 0.1
    covars = []
    for _ in range(K):
        a = rng.normal(size=(dim, dim)) * 0.1
        covars.append(0.09 * (np.eye(dim) + a @ a.T))
    return means, np.stack(covars), rng.dirichlet(np.ones(K))


def _close(port, ref, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port.detach().cpu().numpy(), ref, rtol=RTOL,
                               atol=RTOL * np.abs(ref).max(), err_msg=what)


def _same_gmm(port, ref):
    assert port.dim == ref.dim
    for f in ("means", "chols", "sqrt_neg_log_w"):
        _close(getattr(port, f), getattr(ref, f), f)


def _write(fmt, path, means, covars, weights):
    """The mixture in one of the formats `load_gmm_prior` takes."""
    if fmt == "pkl":
        gmm.save_gmm_prior_pkl({"means": means, "covars": covars,
                                "weights": weights}, path)
    elif fmt == "sklearn":
        gmm.save_gmm_prior_pkl(types.SimpleNamespace(
            means_=means, covars_=covars, weights_=weights), path)
    elif fmt == "dog":
        gmm.save_gmm_prior_pkl({"gmm_means": means, "gmm_covs": covars,
                                "gmm_weights": weights}, path)
    else:
        np.savez(path, means=means, covars=covars, weights=weights)


@pytest.mark.parametrize("npose", [None, 9])
@pytest.mark.parametrize("fmt", ["pkl", "sklearn", "dog", "npz"])
def test_load_gmm_prior_formats(tmp_path, fmt, npose):
    """Each format, whole and truncated to its leading dims, loads to the
    JAX loader's prior."""
    path = str(tmp_path / ("prior.npz" if fmt == "npz" else "prior.pkl"))
    _write(fmt, path, *_moments())
    port = gmm.load_gmm_prior(path, npose=npose, device="cpu")
    _same_gmm(port, jax_gmm.load_gmm_prior(path, npose=npose))
    assert port.means.device.type == "cpu" and port.dim == (npose or 12)


def test_save_gmm_prior_pkl_is_the_reference_dict(tmp_path):
    """The port writes the same pickle as the JAX package."""
    moments = dict(zip(("means", "covars", "weights"), _moments()))
    a, b = tmp_path / "port.pkl", tmp_path / "jax.pkl"
    gmm.save_gmm_prior_pkl(moments, str(a))
    jax_gmm.save_gmm_prior_pkl(moments, str(b))
    assert a.read_bytes() == b.read_bytes()
    with open(a, "rb") as f:
        back = pickle.load(f)
    for k, v in moments.items():
        np.testing.assert_array_equal(back[k], v)


@pytest.mark.parametrize("seed", [0, 1])
def test_gmm_moments_are_the_synthetic_prior(tmp_path, seed):
    """`gmm_moments` draws the JAX package's synthetic mixture: written as
    the reference's pkl and loaded by the JAX loader, it gives JAX's
    `make_gmm_prior`, and so does the port's `make_gmm_prior`."""
    path = str(tmp_path / "prior.pkl")
    gmm.save_gmm_prior_pkl(gmm.gmm_moments(15, 5, seed, 0.3), path)
    ref = jax_gmm.make_gmm_prior(dim=15, num_components=5, seed=seed,
                                 scale=0.3)
    loaded = jax_gmm.load_gmm_prior(path)
    for f in ("means", "chols", "sqrt_neg_log_w"):
        np.testing.assert_allclose(np.asarray(getattr(loaded, f)),
                                   np.asarray(getattr(ref, f)), rtol=RTOL,
                                   atol=RTOL * np.abs(getattr(ref, f)).max())
    _same_gmm(gmm.make_gmm_prior(15, 5, seed, 0.3, device="cpu"), ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_gmm_prior_matches_jax(seed):
    """The same generator state gives the JAX package's samples."""
    prior_j = jax_gmm.make_gmm_prior(dim=15, num_components=5, seed=seed,
                                     scale=0.3)
    prior = gmm.gmm_prior_from_arrays(
        np.asarray(prior_j.means), np.asarray(prior_j.chols),
        np.asarray(prior_j.sqrt_neg_log_w), device="cpu")
    ref = jax_gmm.sample_gmm_prior(prior_j, np.random.default_rng(seed), 257)
    got = gmm.sample_gmm_prior(prior, np.random.default_rng(seed), 257)
    assert got.dtype == np.float32 and got.shape == (257, 15)
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=RTOL * np.abs(ref).max())


def test_sample_gmm_prior_follows_its_mixture():
    """Samples of a two-component mixture split by its weights around its
    means."""
    means = np.stack([np.full(3, -2.0), np.full(3, 2.0)])
    covars = np.stack([np.eye(3) * 0.01] * 2)
    prior = gmm.gmm_prior_from_arrays(
        *gmm._from_moments(means, covars, np.asarray([0.25, 0.75])),
        device="cpu")
    x = gmm.sample_gmm_prior(prior, np.random.default_rng(0), 4000)
    hi = x[:, 0] > 0
    assert abs(hi.mean() - 0.75) < 0.03
    np.testing.assert_allclose(x[hi].mean(0), means[1], atol=0.01)
    np.testing.assert_allclose(x[hi].std(0), 0.1, rtol=0.05)


def _horse_pkl(path, seed=0, n=108):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n)) * 0.1
    with open(path, "wb") as f:
        pickle.dump({"pic": np.linalg.cholesky(np.linalg.inv(
            0.04 * (np.eye(n) + a @ a.T))), "mean_pose": rng.normal(size=n)
            * 0.1}, f)


@pytest.mark.parametrize("disable", [True, False])
def test_load_horse_prior_matches_jax(tmp_path, disable):
    path = str(tmp_path / "horse.pkl")
    _horse_pkl(path)
    port = mahalanobis.load_horse_prior(path, disable, device="cpu")
    ref = jax_mh.load_horse_prior(path, disable)
    n = 81 if disable else 108
    assert port.mean.shape == (n,) and port.prec.shape == (n, n)
    _close(port.mean, ref.mean, "mean")
    _close(port.prec, ref.prec, "prec")
    x = np.random.default_rng(1).normal(size=(5, n)).astype(np.float32) * 0.3
    got = mahalanobis.mahalanobis_residual(port, torch.as_tensor(x))
    want = np.stack([np.asarray(jax_mh.mahalanobis_residual(
        ref, jnp.asarray(xi))) for xi in x])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_horse_leg_rows_and_prior_match_jax(tmp_path):
    """The leg-bend rows on the 12 dofs, and `horse_prior`'s rows: the
    Mahalanobis rows, then 2x the leg-bend rows (the JAX head's callable);
    its Jacobian under vmap(jacfwd) is the closed form."""
    path = str(tmp_path / "horse.pkl")
    _horse_pkl(path, seed=3)
    port = mahalanobis.load_horse_prior(path, device="cpu")
    ref = jax_mh.load_horse_prior(path)
    assert list(mahalanobis._HORSE_ANGLE_IDS) == list(jax_mh._HORSE_ANGLE_IDS)
    x = np.random.default_rng(2).normal(size=(6, 81)).astype(np.float32) * 0.4
    legs = mahalanobis.horse_joint_angle_residual(torch.as_tensor(x))
    want = np.stack([np.asarray(jax_mh.horse_joint_angle_residual(
        jnp.asarray(xi))) for xi in x])
    np.testing.assert_allclose(legs.numpy(), want, rtol=RTOL)
    rows = mahalanobis.horse_prior(port)
    got = rows(torch.as_tensor(x))
    want = np.stack([np.concatenate([
        np.asarray(jax_mh.mahalanobis_residual(ref, jnp.asarray(xi))),
        2.0 * np.asarray(jax_mh.horse_joint_angle_residual(jnp.asarray(xi)))])
        for xi in x])
    assert got.shape == (6, 93)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    jac = torch.func.vmap(torch.func.jacfwd(rows))(torch.as_tensor(x))
    legs_d = np.zeros((6, 12, 81), np.float32)
    for i, k in enumerate(mahalanobis._HORSE_ANGLE_IDS):
        legs_d[:, i, k] = 4.0 * np.exp(2.0 * x[:, k])
    closed = np.concatenate([np.broadcast_to(port.prec.numpy().T,
                                             (6, 81, 81)), legs_d], 1)
    np.testing.assert_allclose(jac.numpy(), closed, rtol=1e-5,
                               atol=1e-5 * np.abs(closed).max())


def test_dog_prior_matches_jax(tmp_path):
    """The dog's 93 pose ids are the family's prior slice, and its GMM
    (the dog's own pkl keys) loads to the JAX loader's."""
    np.testing.assert_array_equal(mahalanobis.DOG_POSE_IDS,
                                  jax_mh.DOG_POSE_IDS)
    assert len(mahalanobis.DOG_POSE_IDS) == 93
    np.testing.assert_array_equal(
        mahalanobis.DOG_POSE_IDS,
        pose_part_ids("animal_dog", optimize_toes=True)["body"])
    path = str(tmp_path / "dog.pkl")
    _write("dog", path, *_moments(dim=93, K=3, seed=4))
    port = mahalanobis.load_dog_prior(path, device="cpu")
    _same_gmm(port, jax_mh.load_dog_prior(path))
    assert isinstance(port, gmm.MaxMixturePrior) and port.dim == 93


def _corpus(seed=0, n=60, dim=9):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(dim, dim)) * 0.3
    return rng.normal(size=(n, dim)) @ a + rng.normal(size=dim)


def test_graphical_lasso_prior_matches_jax():
    """The shrinkage path: the corpus mean and the Cholesky factor of the
    shrunk empirical precision."""
    x = _corpus()
    port = gm_prior.fit_graphical_lasso_prior(x, use_sklearn=False,
                                              device="cpu")
    ref = jax_gm.fit_graphical_lasso_prior(x, use_sklearn=False)
    _close(port.mean, ref.mean, "mean")
    _close(port.prec, ref.prec, "prec")


def test_subject_prior_cache_matches_jax():
    """Subjects with enough samples get their own fit, the rest the
    'Generic' one, each fitted once; the same priors as the JAX cache."""
    x = _corpus(seed=5, n=40)
    names = [f"{'s1' if i < 12 else 's2' if i < 14 else 's3'}_take{i}"
             for i in range(40)]
    port = gm_prior.SubjectPriorCache(x, names, min_samples=3,
                                      use_sklearn=False, device="cpu")
    ref = jax_gm.SubjectPriorCache(x, names, min_samples=3,
                                   use_sklearn=False)
    for sid in ("S1", "s2", "s3", "nobody", "Generic"):
        p, r = port[sid], ref[sid]
        _close(p.mean, r.mean, sid)
        _close(p.prec, r.prec, sid)
    assert port["s2"] is port["Generic"] and port["nobody"] is port["Generic"]
    assert port["S1"] is not port["Generic"] and port["S1"] is port["S1"]
