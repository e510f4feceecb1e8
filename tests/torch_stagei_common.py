"""Shared pieces of the port's stage-i tests (tests/test_torch_stagei.py,
tools/stagei_floor.py): the JAX package's stage-i problems at small size,
the JAX solves they are held to (single, batched and chained into stage
ii, in a fresh interpreter), and the port's copies of the inputs.

The single problem is tests/golden_common.py's `build_stagei_problem`
(SMPL+H, 642 vertices, 10 markers, 3 frames); the batched one adds a
second subject of the same model and layout with its own shape and motion.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp

from golden_common import build_stagei_problem
from torch_families_common import perturbed, port_model

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
BATCH_SUBJECTS = 2
# the chained stage-ii solve (tests/golden_common.py's smplh options)
CHAIN_OPTS = dict(maxiter=40, smoothing_sweeps=1, anchor_stride=2,
                  optimize_fingers=True)


def batched_stagei_problem(sp: dict) -> dict:
    """S = BATCH_SUBJECTS subjects on `sp`'s model and layout: subject 0
    observes `sp`'s frames, the others their own betas and motion (rng 78,
    79, ...) through the same layout vertices at the same skin offset."""
    from moshpp_tpu.models import lbs_forward
    from moshpp_tpu.ops.marker_transform import (marker_coeffs,
                                                 reconstruct_markers,
                                                 select_frame_indices)
    from moshpp_tpu.ops.surface import vertex_normals

    model, kw = sp["model"], sp["kwargs"]
    F, M = kw["frames_mask"].shape
    vids = kw["layout_vids"]
    obs = [kw["frames_obs"]]
    for s in range(1, BATCH_SUBJECTS):
        rng = np.random.default_rng(77 + s)
        betas = (rng.normal(size=16) * 0.3).astype(np.float32)
        can_v = np.asarray(model.v_template) + np.einsum(
            "vcb,b->vc", np.asarray(model.shapedirs)[..., :16], betas)
        vn = np.asarray(vertex_normals(jnp.asarray(can_v), model.faces))
        lat = jnp.asarray(can_v[vids] + vn[vids] * 0.0095)
        idx = select_frame_indices(jnp.asarray(can_v), lat)
        coeffs = marker_coeffs(jnp.asarray(can_v), lat, idx)
        poses = (rng.normal(size=(F, model.pose_dof)) * 0.1).astype(np.float32)
        trans = (rng.normal(size=(F, 3)) * 0.1).astype(np.float32)
        obs.append(np.asarray(jax.vmap(lambda p, t: reconstruct_markers(
            lbs_forward(model, p, jnp.asarray(betas), t), idx, coeffs))(
                jnp.asarray(poses), jnp.asarray(trans))))
    return dict(frames_obs=np.stack(obs),
                frames_mask=np.ones((BATCH_SUBJECTS, F, M), bool))


def _result(res) -> dict:
    """A JAX StageIResult as numpy (its fields, errs included)."""
    d = res._asdict()
    return {k: (np.asarray(v) if hasattr(v, "shape") else v)
            for k, v in d.items()}


def jax_stagei_runs(seeds=(None,), parts=("single", "batched")) -> dict:
    """The JAX package's runs the port is held to, for each seed of
    observation noise (None: the observations as they are): with "single"
    the single solve of the golden problem and its chain into stage ii on
    the same frames (the per-frame mean marker errors), with "batched" the
    batched solve; numpy out."""
    from moshpp_tpu.pipeline.stagei import (mosh_stagei_solve,
                                            mosh_stagei_solve_batched)
    from moshpp_tpu.pipeline.stageii import (StageIIOptions,
                                             mosh_stageii_solve,
                                             prepare_stageii_problem)

    sp = build_stagei_problem()
    kw = sp["kwargs"]
    bp = batched_stagei_problem(sp)
    out = {}
    for seed in seeds:
        out[seed] = {}
        if "single" in parts:
            single = mosh_stagei_solve(
                sp["model"], latent_labels=sp["labels"],
                **dict(kw, frames_obs=perturbed(kw["frames_obs"], seed)))
            o2 = StageIIOptions(**CHAIN_OPTS)
            prob = prepare_stageii_problem(sp["model"], single.betas,
                                           single.markers_latent, opts=o2)
            chain = mosh_stageii_solve(prob, o2, kw["frames_obs"],
                                       kw["frames_mask"], prior=kw["prior"],
                                       model_type="smplh")
            out[seed].update(single=_result(single),
                             chain_err=np.asarray(chain.data_err))
        if "batched" in parts:
            batched = mosh_stagei_solve_batched(
                sp["model"], perturbed(bp["frames_obs"], seed),
                bp["frames_mask"], sp["labels"], kw["layout_vids"],
                kw["m2b"], kw["type_masks"], opts=kw["opts"],
                prior=kw["prior"])
            out[seed]["batched"] = [_result(r) for r in batched]
    return out


# the child's compilation cache lives under the temporary directory of the
# process that runs the tests, as in tests/torch_families_common.py
_CHILD = """
import os, pickle, sys, tempfile
sys.path.insert(0, sys.argv[2])
sys.path.insert(0, sys.argv[3])
import jax
jax.config.update("jax_platforms", "cpu")
from moshpp_tpu.utils.cache import setup_jax_cache
setup_jax_cache(os.path.join(tempfile.gettempdir(), "moshpp_tpu_jax_cache"))
from torch_stagei_common import jax_stagei_runs
with open(sys.argv[1], "wb") as f:
    pickle.dump(jax_stagei_runs(parts=(sys.argv[4],))[None], f)
"""
_PARTS = ("single", "batched")


def start_jax_runs(out_dir):
    """The unperturbed `jax_stagei_runs`, its "single" and its "batched"
    part each in a fresh interpreter (tests/golden_common.py says why),
    started now side by side; returns (result(part) -> that part's runs,
    waiting for them; stop() -> kill what still runs)."""
    procs = {part: subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(out_dir / f"{part}.pkl"), REPO,
         TESTS, part], stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        for part in _PARTS}

    def result(part: str) -> dict:
        _, err = procs[part].communicate(timeout=900)
        assert procs[part].returncode == 0, err.decode()[-2000:]
        with open(out_dir / f"{part}.pkl", "rb") as f:
            return pickle.load(f)

    def stop():
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.communicate()

    return result, stop


def port_inputs(sp: dict, device="cpu") -> dict:
    """The port's model, GMM prior and options for a JAX stage-i problem,
    and its keyword inputs (observations, mask, layout) as numpy."""
    from moshpp_torch.pipeline import stagei
    from moshpp_torch.priors.gmm import gmm_prior_from_arrays

    kw = dict(sp["kwargs"])
    jopts, jprior = kw.pop("opts"), kw.pop("prior")
    prior = gmm_prior_from_arrays(np.asarray(jprior.means),
                                  np.asarray(jprior.chols),
                                  np.asarray(jprior.sqrt_neg_log_w),
                                  device=device)
    names = {f for f in stagei.StageIOptions.__dataclass_fields__}
    opts = stagei.StageIOptions(**{k: v for k, v in vars(jopts).items()
                                   if k in names})
    return dict(model=port_model(sp["model"], device), prior=prior,
                opts=opts, kwargs=kw)
