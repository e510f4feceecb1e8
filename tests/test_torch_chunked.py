"""The port's chunked, resumable stage-ii solve of long sequences against
the JAX package and against its own single-batch solve, on the CPU.

(a) the windows: each chunk [s - H, s + C + H) edge-padded to C + 2H and
    kept to its interior, stitched back in order, host syncs summed;
(b) at tests/test_pipeline.py's sizes (F=48, M=16, chunk_frames=16,
    chunk_halo=8): the port's chunked solve against its unchunked solve and
    against the JAX package's chunked solve (in a fresh interpreter,
    started as the module begins), at that test's bars;
(c) checkpoints, as tests/test_pipeline.py's resume test: a rerun solves
    nothing and returns the same arrays bit for bit, a deleted chunk
    re-solves alone, changed inputs, a corrupt file and a checkpoint the
    JAX package wrote re-solve.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

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
from moshpp_tpu.ops.surface import vertex_normals as jax_normals
from moshpp_tpu.pipeline import stageii as jax_stageii
from moshpp_tpu.priors import make_gmm_prior as jax_make_prior

from moshpp_torch.pipeline import stageii
from moshpp_torch.priors.gmm import gmm_prior_from_arrays
from torch_families_common import port_model

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
BASE = dict(maxiter=60, smoothing_sweeps=1, anchor_stride=4)


def chunk_problem(F: int, M: int, seed: int):
    """tests/test_pipeline.py's SMPL+H problem (400 verts, 6 hand dofs, a
    4-component prior) with F frames of smooth motion seen by M markers,
    in the JAX package: (problem, prior, observations)."""
    rng = np.random.default_rng(seed)
    model = jax_make_model("smplh", num_verts=400, seed=11, dof_per_hand=6)
    prior = jax_make_prior(dim=63, num_components=4, seed=1, scale=0.3)
    vids = rng.choice(model.v_template.shape[0], M, replace=False)
    betas = (rng.normal(size=model.num_betas) * 0.5).astype(np.float32)
    can_v = np.asarray(model.v_template) + np.einsum(
        "vcb,b->vc", np.asarray(model.shapedirs)[..., :model.num_betas], betas)
    vn = np.asarray(jax_normals(jnp.asarray(can_v), model.faces))
    latents = can_v[vids] + vn[vids] * 0.0095
    idx = jax_select(jnp.asarray(can_v), jnp.asarray(latents))
    coeffs = jax_coeffs(jnp.asarray(can_v), jnp.asarray(latents), idx)
    P = model.pose_dof
    poses = np.zeros((F, P), np.float32)
    steps = rng.normal(size=(F, P)).astype(np.float32) * 0.15 * 0.3
    poses[0] = rng.normal(size=P).astype(np.float32) * 0.15
    for t in range(1, F):
        poses[t] = 0.95 * poses[t - 1] + steps[t]
    trans = np.cumsum(rng.normal(size=(F, 3)).astype(np.float32) * 0.01,
                      axis=0) + np.array([0.2, -0.1, 0.5], np.float32)

    def sim(p, t):
        return jax_reconstruct(jax_lbs_forward(model, p, jnp.asarray(betas),
                                               t), idx, coeffs)

    obs = np.asarray(jax.vmap(sim)(jnp.asarray(poses), jnp.asarray(trans)))
    prob = jax_stageii.prepare_stageii_problem(model, betas, latents)
    return prob, prior, obs


def port_problem(jprob, jprior, opts):
    frame_idx = np.stack([np.asarray(c) for c in
                          (jprob.frame_c0, jprob.frame_c1, jprob.frame_c2)], 1)
    prob = stageii.problem_from_arrays(
        port_model(jprob.sub_model), frame_idx, np.asarray(jprob.coeffs),
        np.asarray(jprob.betas), opts, device="cpu")
    prior = gmm_prior_from_arrays(np.asarray(jprior.means),
                                  np.asarray(jprior.chols),
                                  np.asarray(jprior.sqrt_neg_log_w),
                                  device="cpu")
    return prob, prior


def jax_chunked_solve() -> dict:
    """The JAX package's chunked solve of (b)'s problem (numpy out)."""
    prob, prior, obs = chunk_problem(48, 16, seed=42)
    res = jax_stageii.mosh_stageii_solve(
        prob, jax_stageii.StageIIOptions(**BASE, chunk_frames=16,
                                         chunk_halo=8),
        obs, np.ones(obs.shape[:2], bool), prior=prior)
    return {k: np.asarray(getattr(res, k))
            for k in ("data_err", "markers_sim", "trans")}


# The child's compilation cache lives under the temporary directory of the
# process that runs the tests, as in tests/test_torch_face.py.
_CHILD = """
import os, pickle, sys, tempfile
sys.path.insert(0, sys.argv[2])
sys.path.insert(0, sys.argv[3])
import jax
jax.config.update("jax_platforms", "cpu")
from moshpp_tpu.utils.cache import setup_jax_cache
setup_jax_cache(os.path.join(tempfile.gettempdir(), "moshpp_tpu_jax_cache"))
from test_torch_chunked import jax_chunked_solve
with open(sys.argv[1], "wb") as f:
    pickle.dump(jax_chunked_solve(), f)
"""


@pytest.fixture(scope="module", autouse=True)
def jax_reference(tmp_path_factory):
    """`jax_chunked_solve()` in a fresh interpreter, started as this
    module's tests begin; (b) waits for it."""
    out = tmp_path_factory.mktemp("chunked") / "jax_chunked.pkl"
    proc = subprocess.Popen([sys.executable, "-c", _CHILD, str(out), REPO,
                             TESTS], stdout=subprocess.DEVNULL,
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


def _window_recorder(calls):
    """A stand-in for the inner solve that records each window and answers
    with the window's own observations as the fitted markers and each
    frame's first coordinate as its data error."""
    real = stageii.StageIIResult

    def solve(prob, opts, obs, mask, prior=None, model_type=None, *,
              device):
        assert opts.chunk_frames == 0
        obs = torch.as_tensor(obs)
        calls.append((obs.clone(), torch.as_tensor(mask).clone()))
        W = obs.shape[0]
        z = lambda *s: torch.zeros((W,) + s)
        return real(trans=obs[:, 0], pose=z(5), fullpose=z(5), extra=z(0),
                    markers_sim=obs, data_err=obs[:, 0, 0],
                    iterations=torch.zeros(W, dtype=torch.int32),
                    host_syncs=7)
    return solve


@pytest.mark.parametrize("F,C,H", [(44, 16, 8), (48, 16, 8), (17, 16, 4),
                                   (100, 30, 0)])
def test_chunk_windows_and_stitching(monkeypatch, F, C, H):
    """(a) chunk s solves frames [s - H, s + C + H) clipped to the sequence,
    the tail padded with its last frame to C + 2H; the kept interiors
    give back every frame in order; host syncs are summed."""
    calls = []
    monkeypatch.setattr(stageii, "mosh_stageii_solve", _window_recorder(calls))
    obs = torch.arange(F * 2 * 3, dtype=torch.float32).reshape(F, 2, 3)
    mask = torch.ones(F, 2, dtype=torch.bool)
    mask[::3, 1] = False
    opts = stageii.StageIIOptions(chunk_frames=C, chunk_halo=H)
    res = stageii._solve_chunked(None, opts, obs, mask, None, "smplh", "cpu")
    starts = list(range(0, F, C))
    assert len(calls) == len(starts)
    for s, (o, m) in zip(starts, calls):
        lo, hi = max(0, s - H), min(F, s + C + H)
        assert o.shape == (C + 2 * H, 2, 3)
        assert torch.equal(o[:hi - lo], obs[lo:hi])
        assert torch.equal(m[:hi - lo], mask[lo:hi])
        assert (o[hi - lo:] == obs[hi - 1]).all()
        assert (m[hi - lo:] == mask[hi - 1]).all()
    assert torch.equal(res.markers_sim, obs)
    assert torch.equal(res.trans, obs[:, 0])
    assert res.iterations.shape == (F,) and res.extra.shape == (F, 0)
    assert res.host_syncs == 7 * len(starts)


def test_chunked_matches_unchunked_and_jax(jax_reference):
    """(b) the chunked solve agrees with the single-batch solve and with the
    JAX chunked solve: mean marker error within 0.05 mm and fitted markers
    within 1.0 mm across every seam (tests/test_pipeline.py's bars)."""
    jprob, jprior, obs = chunk_problem(48, 16, seed=42)
    mask = np.ones(obs.shape[:2], bool)
    full_opts = stageii.StageIIOptions(**BASE, chunk_frames=0)
    chunk_opts = stageii.StageIIOptions(**BASE, chunk_frames=16, chunk_halo=8)
    prob, prior = port_problem(jprob, jprior, full_opts)
    res_full = stageii.mosh_stageii_solve(prob, full_opts, obs, mask,
                                          prior=prior, device="cpu")
    res_chunk = stageii.mosh_stageii_solve(prob, chunk_opts, obs, mask,
                                           prior=prior, device="cpu")
    for f in stageii.StageIIResult._fields[:-1]:
        assert getattr(res_chunk, f).shape == getattr(res_full, f).shape, f
    assert res_chunk.host_syncs > res_full.host_syncs > 0
    ref = jax_reference()
    err_chunk = float(res_chunk.data_err.mean()) * 1e3
    for other in (float(res_full.data_err.mean()) * 1e3,
                  float(ref["data_err"].mean()) * 1e3):
        assert abs(err_chunk - other) < 0.05, (err_chunk, other)
    sim = res_chunk.markers_sim.numpy()
    for other in (res_full.markers_sim.numpy(), ref["markers_sim"]):
        dev_mm = 1e3 * np.abs(sim - other).max()
        assert dev_mm < 1.0, f"max seam deviation {dev_mm:.3f} mm"


def test_chunk_checkpoint_resume(monkeypatch, tmp_path):
    """(c) resume from checkpoints, and every way a checkpoint goes
    stale."""
    jprob, jprior, obs = chunk_problem(24, 12, seed=3)
    mask = np.ones(obs.shape[:2], bool)
    ckpt = tmp_path / "ckpt"
    opts = stageii.StageIIOptions(maxiter=30, smoothing_sweeps=1,
                                  anchor_stride=4, chunk_frames=12,
                                  chunk_halo=4, checkpoint_dir=str(ckpt))
    prob, prior = port_problem(jprob, jprior, opts)

    inner = []
    real_solve = stageii.mosh_stageii_solve

    def counting_solve(prob, opts, *a, **kw):
        if opts.chunk_frames == 0:
            inner.append(1)
        return real_solve(prob, opts, *a, **kw)

    monkeypatch.setattr(stageii, "mosh_stageii_solve", counting_solve)

    def run(o=obs):
        inner.clear()
        return counting_solve(prob, opts, o, mask, prior=prior, device="cpu")

    res1 = run()
    assert len(inner) == 2 and res1.host_syncs > 0
    files = sorted(p.name for p in ckpt.iterdir())
    assert files == ["chunk_000000000.npz", "chunk_000000012.npz"]

    # a rerun: everything loaded, no solve, the same arrays bit for bit
    res2 = run()
    assert len(inner) == 0 and res2.host_syncs == 0
    for f in stageii.StageIIResult._fields[:-1]:
        a, b = getattr(res1, f), getattr(res2, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f

    # the second chunk lost: it alone re-solves, to the same arrays
    (ckpt / "chunk_000000012.npz").unlink()
    res3 = run()
    assert len(inner) == 1
    assert torch.equal(res1.trans, res3.trans)

    # a truncated file (a crash mid-write) re-solves
    path = ckpt / "chunk_000000000.npz"
    path.write_bytes(path.read_bytes()[:100])
    run()
    assert len(inner) == 1

    # changed inputs and changed options fail the fingerprint
    run(obs + 1e-6)
    assert len(inner) == 2
    opts = dataclasses.replace(opts, weights={"velo": 3.0})
    run(obs + 1e-6)
    assert len(inner) == 2
    run(obs + 1e-6)
    assert len(inner) == 0

    # a checkpoint the JAX package wrote for the same window never matches
    jopts = jax_stageii.StageIIOptions(
        maxiter=30, smoothing_sweeps=1, anchor_stride=4, chunk_frames=0,
        chunk_halo=4, weights={"velo": 3.0})
    window = slice(0, 16)
    jfp = jax_stageii._chunk_fingerprint(jprob, jopts, obs[window] + 1e-6,
                                         mask[window])
    jax_stageii._chunk_ckpt_save(str(path), jfp, jax_stageii.StageIIResult(
        *[getattr(res1, f)[:12].numpy()
          for f in stageii.StageIIResult._fields[:-1]]), None)
    run(obs + 1e-6)
    assert len(inner) == 1
