"""Shared pieces of the port's family tests (tests/test_torch_families.py,
tests/test_torch_animals.py): the port's problem, options and prior from a
`golden_common` problem, the JAX solves (in fresh interpreters) they are
held to, and the system and solve comparisons.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import torch

from golden_common import build_family_problem
from moshpp_tpu.pipeline import stageii as jax_stageii

from moshpp_torch.models.body_model import surface_model_from_arrays
from moshpp_torch.pipeline import stageii
from moshpp_torch.priors.gmm import gmm_prior_from_arrays

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
_MODEL_FIELDS = ("v_template", "shapedirs", "posedirs", "weights",
                 "joint_template", "joint_shapedirs", "hands_components",
                 "hands_mean", "faces")


def port_model(jmodel, device="cpu"):
    """The port's copy of a JAX `SurfaceModel`."""
    return surface_model_from_arrays(
        {f: np.asarray(getattr(jmodel, f)) for f in _MODEL_FIELDS},
        jmodel.model_type, jmodel.parents, jmodel.dof_per_hand,
        num_betas=jmodel.num_betas, skin_k=jmodel.skin_k, device=device)


def port_opts(jopts) -> stageii.StageIIOptions:
    """The port's options with every field the JAX options share."""
    names = {f.name for f in dataclasses.fields(stageii.StageIIOptions)}
    return stageii.StageIIOptions(**{
        f.name: getattr(jopts, f.name)
        for f in dataclasses.fields(jopts) if f.name in names})


def port_prior(family, jprior, device="cpu"):
    """The port's prior of a golden_common family: the GMM's arrays, or
    for the horse the same callable rebuilt from golden_common's seed."""
    if jprior is None:
        return None
    if family == "animal_horse":
        dim = 81
        mean = torch.as_tensor(
            (np.random.default_rng(21).normal(size=dim) * 0.05).astype(
                np.float32), device=device)
        return lambda pose_body: (pose_body - mean) * 0.8
    return gmm_prior_from_arrays(np.asarray(jprior.means),
                                 np.asarray(jprior.chols),
                                 np.asarray(jprior.sqrt_neg_log_w),
                                 device=device)


def port_problem(fp, device="cpu"):
    """The port's (problem, options, prior) from a golden_common problem,
    built from the JAX problem's frozen fields."""
    jp = fp["prob"]
    opts = port_opts(fp["opts"])
    frame_idx = np.stack([np.asarray(c) for c in
                          (jp.frame_c0, jp.frame_c1, jp.frame_c2)], axis=1)
    prob = stageii.problem_from_arrays(
        port_model(jp.sub_model, device), frame_idx, np.asarray(jp.coeffs),
        np.asarray(jp.betas), opts, device=device)
    return prob, opts, port_prior(fp["family"], fp["prior"], device)


def build_problems(families):
    """{family: (golden_common problem, the port's (problem, options,
    prior))}."""
    out = {}
    for family in families:
        fp = build_family_problem(family)
        fp["family"] = family
        out[family] = (fp, port_problem(fp))
    return out


# Observation noise of the floor's solves (m) and its seeds: the solve's own
# sensitivity to rounding, as chip_smoke.py's parity gate measures it
NOISE_M = 1e-7
PORT_SEEDS = (None, 7, 8, 9, 10)
JAX_SEEDS = (None,) + tuple(range(7, 17))


def perturbed(obs, seed):
    """The observations, or with NOISE_M of noise drawn from `seed`."""
    if seed is None:
        return obs
    return obs + NOISE_M * np.random.default_rng(seed).standard_normal(
        obs.shape).astype(np.float32)


def jax_family_solves(family: str) -> dict:
    """The JAX package's solves of the family's golden_common problem, its
    observations as they are (None) and moved by NOISE_M for each of
    JAX_SEEDS (numpy out)."""
    from moshpp_tpu.pipeline.stageii import mosh_stageii_solve
    fp = build_family_problem(family)
    out = {}
    for seed in JAX_SEEDS:
        res = mosh_stageii_solve(fp["prob"], fp["opts"],
                                 perturbed(fp["obs"], seed), fp["mask"],
                                 prior=fp["prior"], model_type=family)
        out[seed] = {k: np.asarray(getattr(res, k))
                     for k in ("data_err", "markers_sim", "trans")}
    return out


# The child's compilation cache lives under the temporary directory of the
# process that runs the tests, as in tests/test_torch_face.py.
_CHILD = """
import os, pickle, sys, tempfile
sys.path.insert(0, sys.argv[3])
sys.path.insert(0, sys.argv[4])
import jax
jax.config.update("jax_platforms", "cpu")
from moshpp_tpu.utils.cache import setup_jax_cache
setup_jax_cache(os.path.join(tempfile.gettempdir(), "moshpp_tpu_jax_cache"))
from torch_families_common import jax_family_solves
with open(sys.argv[2], "wb") as f:
    pickle.dump(jax_family_solves(sys.argv[1]), f)
"""


def start_jax_solves(families, out):
    """`jax_family_solves(family)` of each family, each in a fresh
    interpreter (tests/golden_common.py says why), started now; returns
    (result(family) -> the solves, waiting for them; stop() -> kill what
    still runs)."""
    procs = {f: subprocess.Popen(
        [sys.executable, "-c", _CHILD, f, str(out / f"{f}.pkl"), REPO,
         TESTS], stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        for f in families}

    def result(family: str) -> dict:
        proc = procs[family]
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err.decode()[-2000:]
        with open(out / f"{family}.pkl", "rb") as f:
            return pickle.load(f)

    def stop():
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.communicate()

    return result, stop


def _probe_aux(fp, N, rng):
    """Per-frame aux around the golden probe: anneal, prior scale, velocity
    anchors and (with extras) extra anchors varied per frame."""
    D = fp["x_probe"].shape[0]
    P = fp["prob"].sub_model.pose_dof
    E = D - 3 - P
    M = fp["obs"].shape[1]
    obs = np.concatenate([fp["obs"]] * (N // fp["obs"].shape[0] + 1))[:N]
    mask = np.concatenate([fp["mask"]] * (N // fp["mask"].shape[0] + 1))[:N]
    aux = {
        "markers": obs.astype(np.float32),
        "mask": mask.astype(np.float32),
        "wt_data": np.full(N, 400.0 * 46.0 / M, np.float32),
        "anneal": rng.uniform(1.0, 2.0, N).astype(np.float32),
        "wt_pose_scale": np.asarray([1.0, 10.0, 5.0, 1.0][:N], np.float32),
        "velo_anchor": (rng.normal(size=(N, P)) * 0.1).astype(np.float32),
        "velo_on": np.asarray([0.0, 1.0, 1.0, 0.0][:N], np.float32),
        "extra_anchor": (rng.normal(size=(N, E)) * 0.1).astype(np.float32),
        "extra_on": np.full(N, 1.0 if E else 0.0, np.float32),
    }
    x = (np.asarray(fp["x_probe"])[None]
         + rng.normal(size=(N, D)) * 0.05).astype(np.float32)
    return x, aux


def check_system(fp, prob, opts, prior, jprior, family):
    """(f, g, B) and the cost of the port's system against the JAX
    system's, each within 1e-4 of its largest magnitude."""
    x, aux = _probe_aux(fp, 4, np.random.default_rng(8))
    jaux = {k: jnp.asarray(v) for k, v in aux.items()}
    sysj = jax_stageii.make_stageii_system(fp["prob"], fp["opts"], jprior,
                                           family)
    ref = jax.vmap(sysj.system_fn)(jnp.asarray(x), jaux)
    cost_ref = np.asarray(jax.vmap(sysj.cost_fn)(jnp.asarray(x), jaux))
    syst = stageii.make_stageii_system(prob, opts, prior, family)
    taux = {k: torch.as_tensor(v) for k, v in aux.items()}
    out = syst.system_fn(torch.as_tensor(x), taux)
    for name, a, r in zip(("f", "g", "B"), out, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(a.numpy(), r, atol=1e-4 * np.abs(r).max(),
                                   err_msg=f"{family} {name}")
    cost = syst.cost_fn(torch.as_tensor(x), taux).numpy()
    np.testing.assert_allclose(cost, cost_ref,
                               atol=1e-4 * np.abs(cost_ref).max())
    np.testing.assert_allclose(cost, out[0].numpy(),
                               atol=1e-5 * np.abs(out[0].numpy()).max())
    return out


# tests/test_goldens.py's outcome tolerances (mm)
MEAN_MM, SIM_MM, TRANS_MM = 0.1, 0.3, 2.0
FLOOR_FACTOR = 1.5


def check_solve(problems, jax_solves, family):
    """The whole CPU solve against the live JAX solve of the same problem,
    at tests/test_goldens.py's outcome tolerances where the JAX solve itself
    holds them.

    Every port solve (the observations as they are, and moved by NOISE_M
    for four seeds) keeps its mean marker error within 0.1 mm of the JAX
    solve's. The fitted markers and trans are not all fixed by the data:
    two markers go unobserved in frame 1, and 10 markers on 4 frames leave
    pose dofs to the prior, so the trial points a solve stops at move with
    its rounding (the JAX solves of smpl whose observations differ by
    1e-7 m leave those markers up to ~30 mm apart, and the dog's trans up
    to ~45 mm). Their deviation from the JAX solve, the median over the
    port's solves, stays within max(tolerance, FLOOR_FACTOR x the JAX
    floor): the largest deviation between the JAX solve and its own solves
    moved by NOISE_M over JAX_SEEDS' ten seeds."""
    fp, (prob, opts, prior) = problems[family]
    ref = jax_solves(family)
    base = ref[None]
    F, M = fp["mask"].shape
    floor_sim = max(np.abs(ref[s]["markers_sim"] - base["markers_sim"]).max()
                    for s in JAX_SEEDS[1:]) * 1e3
    floor_tr = max(np.abs(ref[s]["trans"] - base["trans"]).max()
                   for s in JAX_SEEDS[1:]) * 1e3
    d_sim, d_tr = [], []
    for seed in PORT_SEEDS:
        res = stageii.mosh_stageii_solve(prob, opts,
                                         perturbed(fp["obs"], seed),
                                         fp["mask"], prior=prior,
                                         model_type=family, device="cpu")
        assert res.markers_sim.shape == (F, M, 3) and res.host_syncs > 0
        err_mm = float(res.data_err.mean()) * 1e3
        ref_mm = float(base["data_err"].mean()) * 1e3
        assert abs(err_mm - ref_mm) < MEAN_MM, (family, seed, err_mm, ref_mm)
        d_sim.append(np.abs(res.markers_sim.numpy()
                            - base["markers_sim"]).max() * 1e3)
        d_tr.append(np.abs(res.trans.numpy() - base["trans"]).max() * 1e3)
    lim_sim = max(SIM_MM, FLOOR_FACTOR * floor_sim)
    lim_tr = max(TRANS_MM, FLOOR_FACTOR * floor_tr)
    msg = (f"{family}: fitted markers {np.round(d_sim, 4)} mm (limit "
           f"{lim_sim:.4f}), trans {np.round(d_tr, 4)} mm (limit "
           f"{lim_tr:.4f})")
    print(msg)       # shown with pytest -s: each port solve's deviations
    assert np.median(d_sim) <= lim_sim, msg
    assert np.median(d_tr) <= lim_tr, msg
