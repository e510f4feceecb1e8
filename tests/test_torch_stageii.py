"""The port's stage-ii slice against the JAX package, on the CPU.

(a) the batched Gauss-Newton system (f, g, B) at probe points of the golden
    smplh problem; (b) the full `mosh_stageii_solve` outcome; (c) the port
    never imports JAX; (d) `chip_smoke.py` refuses to run without a card.

The solve tests build the port's problem from the JAX problem's frozen
fields (`problem_from_arrays`), so both solve the same marker frames.
"""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from golden_common import build_family_problem, golden_solve
from moshpp_tpu.pipeline.stageii import make_stageii_system as jax_system

from moshpp_torch.models.body_model import surface_model_from_arrays
from moshpp_torch.pipeline import stageii
from moshpp_torch.priors.gmm import gmm_prior_from_arrays

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_GOLDEN = os.path.join(REPO, "tests", "goldens", "stageii_smplh.npz")
_MODEL_FIELDS = ("v_template", "shapedirs", "posedirs", "weights",
                 "joint_template", "joint_shapedirs", "hands_components",
                 "hands_mean", "faces")


def port_problem(fp):
    """The port's (problem, options, prior) from a golden_common problem."""
    jp, jo, jprior = fp["prob"], fp["opts"], fp["prior"]
    sub = jp.sub_model
    model = surface_model_from_arrays(
        {f: np.asarray(getattr(sub, f)) for f in _MODEL_FIELDS},
        sub.model_type, sub.parents, sub.dof_per_hand,
        num_betas=sub.num_betas, skin_k=sub.skin_k, device="cpu")
    opts = stageii.StageIIOptions(
        maxiter=jo.maxiter, smoothing_sweeps=jo.smoothing_sweeps,
        anchor_stride=jo.anchor_stride, optimize_fingers=jo.optimize_fingers)
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
def smplh():
    fp = build_family_problem("smplh")
    return fp, port_problem(fp)


def test_system_matches_jax(smplh):
    """(a) (f, g, B) at probe points around the golden probe, with anneal,
    prior scale and velocity anchors varied per frame."""
    fp, (prob, opts, prior) = smplh
    rng = np.random.default_rng(8)
    N = 4
    D = fp["x_probe"].shape[0]
    P = D - 3
    x = (np.asarray(fp["x_probe"])[None]
         + rng.normal(size=(N, D)) * 0.05).astype(np.float32)
    aux = {
        "markers": fp["obs"].astype(np.float32),
        "mask": fp["mask"].astype(np.float32),
        "wt_data": np.full(N, 400.0 * 46.0 / 10, np.float32),
        "anneal": np.asarray([1.0, 1.5, 2.0, 1.0], np.float32),
        "wt_pose_scale": np.asarray([1.0, 10.0, 5.0, 1.0], np.float32),
        "velo_anchor": (rng.normal(size=(N, P)) * 0.1).astype(np.float32),
        "velo_on": np.asarray([0.0, 1.0, 1.0, 0.0], np.float32),
    }
    jaux = {k: jnp.asarray(v) for k, v in aux.items()}
    jaux["extra_anchor"] = jnp.zeros((N, 0))
    jaux["extra_on"] = jnp.zeros((N,))
    sysj = jax_system(fp["prob"], fp["opts"], fp["prior"], "smplh")
    ref = jax.vmap(sysj.system_fn)(jnp.asarray(x), jaux)
    cost_ref = jax.vmap(sysj.cost_fn)(jnp.asarray(x), jaux)

    syst = stageii.make_stageii_system(prob, opts, prior, "smplh")
    taux = {k: torch.as_tensor(v) for k, v in aux.items()}
    out = syst.system_fn(torch.as_tensor(x), taux)
    for name, a, r in zip(("f", "g", "B"), out, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(a.numpy(), r,
                                   atol=1e-4 * np.abs(r).max(), err_msg=name)
    cost = syst.cost_fn(torch.as_tensor(x), taux)
    np.testing.assert_allclose(cost.numpy(), np.asarray(cost_ref),
                               atol=1e-4 * np.abs(np.asarray(cost_ref)).max())
    np.testing.assert_allclose(cost.numpy(), out[0].numpy(),
                               atol=1e-5 * np.abs(out[0].numpy()).max())


def test_solve_matches_jax(smplh):
    """(b) the full CPU solve, held at tests/test_goldens.py's outcome
    tolerances to the JAX package's solve of the same problem, and to the
    committed golden's mean marker error."""
    fp, (prob, opts, prior) = smplh
    res = stageii.mosh_stageii_solve(prob, opts, fp["obs"], fp["mask"],
                                     prior=prior, model_type="smplh",
                                     device="cpu")
    assert res.host_syncs > 0
    err_mm = res.data_err.numpy().mean() * 1e3
    golden = np.load(_GOLDEN)
    assert abs(err_mm - golden["data_err"].mean() * 1e3) < 0.1
    ref = golden_solve("smplh")
    assert abs(err_mm - ref["data_err"].mean() * 1e3) < 0.1
    d_sim = np.abs(res.markers_sim.numpy() - ref["markers_sim"]).max() * 1e3
    assert d_sim < 0.3, f"fitted markers moved {d_sim:.4f} mm"
    d_tr = np.abs(res.trans.numpy() - ref["trans"]).max() * 1e3
    assert d_tr < 2.0, f"trans moved {d_tr:.4f} mm"


def test_unported_options_raise(smplh):
    """Chunked solves and callable priors are ported (tests/
    test_torch_chunked.py, tests/test_torch_families.py); telemetry is
    not."""
    fp, (prob, opts, prior) = smplh
    with pytest.raises(NotImplementedError):
        stageii.mosh_stageii_solve(prob, opts, fp["obs"], fp["mask"],
                                   prior=prior, return_report=True,
                                   device="cpu")


_IMPORT_ALL = """
import importlib, pkgutil, sys
import moshpp_torch
for m in pkgutil.walk_packages(moshpp_torch.__path__, "moshpp_torch."):
    importlib.import_module(m.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "moshpp_tpu"))
assert not bad, bad
print("ok")
"""


def test_port_never_imports_jax():
    """(c) every module of the port imports without JAX or the JAX package."""
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "ok"


def _no_ok_line(stdout: str) -> bool:
    return not any(line.startswith('{"ok"') for line in stdout.splitlines())


def test_chip_smoke_fails_without_a_card():
    """(d) here there is no CUDA device: nonzero exit, no ok line; and a
    directory holding only the script fails too."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    script = os.path.join(REPO, "chip_smoke.py")
    r = subprocess.run([sys.executable, script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert _no_ok_line(r.stdout)
    with tempfile.TemporaryDirectory() as d:
        with open(script) as src, open(os.path.join(d, "chip_smoke.py"),
                                       "w") as dst:
            dst.write(src.read())
        env["PYTHONPATH"] = ""
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=d, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert _no_ok_line(r.stdout)
