"""The port's frame-sharded stage ii (`moshpp_torch.parallel.sharding`, the
mesh path of `mosh_stageii_solve`) on the CPU, on shards `["cpu"] * n`.

(a) `pad_frames` is the JAX package's;
(b) on tests/test_sharding.py's problem (600 vertices, F=64, maxiter 40,
    one sweep) the 2- and 8-shard solves agree with the unsharded solve at
    that test's bars (mean data error within 5e-5 m, any fitted marker
    within 2e-4 m), and `mosh_stageii_solve_sharded` is the mesh solve;
(c) the port's 2-shard solve against the JAX package's
    `mosh_stageii_solve_sharded` on a 2-device JAX mesh (in a fresh
    interpreter, started as the module begins), by the quality-parity
    gates (0.02 mm mean marker error, 0.6 mm wander);
(d) chunks on a mesh: F=40, chunk_frames 16, chunk_halo 6, 8 shards (each
    window of 28 rounds up to 32) against the unchunked unsharded solve at
    tests/test_sharding.py's chunked bars (1e-4 m, 1e-3 m);
(e) a frame count that is no multiple of the shards gives back F frames;
    a mesh that names a device this process lacks raises; the problem and
    a callable prior's closure are replicated onto each shard's device.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from moshpp_tpu.parallel import sharding as jax_sharding
from moshpp_tpu.pipeline import stageii as jax_stageii

from moshpp_torch.parallel import (frame_mesh, mosh_stageii_solve_sharded,
                                   pad_frames)
from moshpp_torch.pipeline import stageii
from test_sharding import _tiny_problem
from test_torch_chunked import port_problem

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
SOLVE = dict(maxiter=40, smoothing_sweeps=1, optimize_fingers=True)
CHUNK = dict(maxiter=30, smoothing_sweeps=1, anchor_stride=4)
PARITY_MEAN_MM, PARITY_WANDER_MM = 0.02, 0.6


def jax_sharded_solve() -> dict:
    """The JAX package's solve of (b)'s problem on a 2-device mesh."""
    import jax
    model, betas, latents, prior, obs, mask = _tiny_problem()
    opts = jax_stageii.StageIIOptions(**SOLVE)
    prob = jax_stageii.prepare_stageii_problem(model, betas, latents,
                                               opts=opts)
    res = jax_sharding.mosh_stageii_solve_sharded(
        prob, opts, obs, mask, prior=prior, model_type="smplh",
        mesh=jax_sharding.frame_mesh(jax.devices()[:2]))
    return {k: np.asarray(getattr(res, k)) for k in ("data_err",
                                                     "markers_sim")}


_CHILD = """
import os, pickle, sys, tempfile
sys.path.insert(0, sys.argv[2])
sys.path.insert(0, sys.argv[3])
import jax
jax.config.update("jax_platforms", "cpu")
from moshpp_tpu.utils.cache import setup_jax_cache
setup_jax_cache(os.path.join(tempfile.gettempdir(), "moshpp_tpu_jax_cache"))
from test_torch_parallel import jax_sharded_solve
with open(sys.argv[1], "wb") as f:
    pickle.dump(jax_sharded_solve(), f)
"""


@pytest.fixture(scope="module", autouse=True)
def jax_reference(tmp_path_factory):
    """`jax_sharded_solve()` in a fresh interpreter with 8 virtual CPU
    devices, started as this module's tests begin; (c) waits for it."""
    out = tmp_path_factory.mktemp("parallel") / "jax_sharded.pkl"
    env = dict(os.environ, XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"))
    proc = subprocess.Popen([sys.executable, "-c", _CHILD, str(out), REPO,
                             TESTS], stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, env=env)

    def result() -> dict:
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err.decode()[-2000:]
        with open(out, "rb") as f:
            return pickle.load(f)

    yield result
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def tiny():
    """(b)'s problem in the port (the JAX problem's arrays) and its
    unsharded solve."""
    model, betas, latents, prior, obs, mask = _tiny_problem()
    opts = stageii.StageIIOptions(**SOLVE)
    jprob = jax_stageii.prepare_stageii_problem(
        model, betas, latents, opts=jax_stageii.StageIIOptions(**SOLVE))
    prob, pprior = port_problem(jprob, prior, opts)
    res = stageii.mosh_stageii_solve(prob, opts, obs, mask, prior=pprior,
                                     model_type="smplh", device="cpu")
    return dict(prob=prob, prior=pprior, opts=opts, obs=obs, mask=mask,
                res=res)


def _gap(a, b):
    """(|difference of the mean data errors|, largest fitted-marker
    difference), in m."""
    mean = lambda r: float(np.mean(np.asarray(r.data_err)))
    return (abs(mean(a) - mean(b)),
            float(np.abs(np.asarray(a.markers_sim)
                         - np.asarray(b.markers_sim)).max()))


@pytest.mark.parametrize("F,n", [(10, 8), (16, 8), (61, 2), (1, 4)])
def test_pad_frames_is_jaxs(F, n):
    """(a)"""
    rng = np.random.default_rng(F)
    obs = rng.normal(size=(F, 4, 3)).astype(np.float32)
    mask = rng.random((F, 4)) > 0.3
    ours, theirs = pad_frames(obs, mask, n), jax_sharding.pad_frames(obs,
                                                                     mask, n)
    assert ours[2] == theirs[2] == F
    for a, b in zip(ours[:2], theirs[:2]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert ours[0].shape[0] % n == 0 and not ours[1][F:].any()


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_matches_unsharded(tiny, n):
    """(b) at tests/test_sharding.py's bars; the shards' host syncs sum to
    the result's."""
    mesh = frame_mesh(["cpu"] * n)
    res, rep = stageii.mosh_stageii_solve(
        tiny["prob"], tiny["opts"], tiny["obs"], tiny["mask"],
        prior=tiny["prior"], model_type="smplh", device="cpu", mesh=mesh,
        return_report=True)
    d_mean, d_max = _gap(res, tiny["res"])
    assert d_mean < 5e-5 and d_max < 2e-4, (d_mean, d_max)
    assert res.fullpose.shape == tiny["res"].fullpose.shape
    assert len(rep.shard_syncs) == n and sum(rep.shard_syncs) == res.host_syncs
    if n == 2:
        api = mosh_stageii_solve_sharded(
            tiny["prob"], tiny["opts"], tiny["obs"], tiny["mask"],
            prior=tiny["prior"], model_type="smplh", mesh=mesh)
        assert isinstance(api.markers_sim, np.ndarray)
        np.testing.assert_array_equal(api.markers_sim,
                                      res.markers_sim.numpy())
        assert api.host_syncs == res.host_syncs


def test_sharded_matches_jax_sharded(tiny, jax_reference):
    """(c) the port's 2-shard solve and the JAX package's on a 2-device
    mesh, by the quality-parity gates."""
    ref = jax_reference()
    res = mosh_stageii_solve_sharded(
        tiny["prob"], tiny["opts"], tiny["obs"], tiny["mask"],
        prior=tiny["prior"], model_type="smplh",
        mesh=frame_mesh(["cpu"] * 2))
    d_mean = abs(res.data_err.mean() - ref["data_err"].mean()) * 1e3
    wander = np.abs(res.markers_sim - ref["markers_sim"]).max() * 1e3
    assert d_mean <= PARITY_MEAN_MM and wander <= PARITY_WANDER_MM, (
        d_mean, wander)


def test_chunks_on_a_mesh():
    """(d) every chunk's window rounds up to a multiple of the 8 shards,
    and the chunked sharded solve stays within the chunked bars of the
    unchunked unsharded one."""
    model, betas, latents, prior, obs, mask = _tiny_problem(frames=40,
                                                            markers=12)
    jprob = jax_stageii.prepare_stageii_problem(
        model, betas, latents, opts=jax_stageii.StageIIOptions(**CHUNK))
    ref_opts = stageii.StageIIOptions(**CHUNK, chunk_frames=0)
    prob, pprior = port_problem(jprob, prior, ref_opts)
    ref = stageii.mosh_stageii_solve(prob, ref_opts, obs, mask, prior=pprior,
                                     model_type="smplh", device="cpu")
    widths = set()
    res = stageii.mosh_stageii_solve(
        prob, stageii.StageIIOptions(**CHUNK, chunk_frames=16, chunk_halo=6),
        obs, mask, prior=pprior, model_type="smplh", device="cpu",
        mesh=frame_mesh(["cpu"] * 8),
        on_phase=lambda name, x, sim: widths.add((name, x.shape[0])))
    assert {w for name, w in widths if name == "polish"} == {32}
    assert res.trans.shape == (40, 3)
    d_mean, d_max = _gap(res, ref)
    assert d_mean < 1e-4 and d_max < 1e-3, (d_mean, d_max)


def test_frame_count_not_a_multiple():
    """(e) 13 frames on 4 shards: every phase pads its batch with
    all-missing frames and slices them away."""
    model, betas, latents, prior, obs, mask = _tiny_problem(frames=13,
                                                            markers=12)
    opts = stageii.StageIIOptions(**CHUNK)
    jprob = jax_stageii.prepare_stageii_problem(
        model, betas, latents, opts=jax_stageii.StageIIOptions(**CHUNK))
    prob, pprior = port_problem(jprob, prior, opts)
    res = mosh_stageii_solve_sharded(prob, opts, obs, mask, prior=pprior,
                                     model_type="smplh",
                                     mesh=frame_mesh(["cpu"] * 4))
    assert res.trans.shape == (13, 3) and res.markers_sim.shape == (13, 12, 3)
    assert res.iterations.shape == (13,)
    assert np.isfinite(res.markers_sim).all()
    assert res.data_err.mean() < 5e-3


def test_mesh_devices_are_checked():
    """(e) a mesh names its devices; one this process lacks raises."""
    mesh = frame_mesh(["cpu", torch.device("cpu")])
    assert mesh.devices == (torch.device("cpu"),) * 2
    assert mesh.shape == {"frames": 2}
    absent = f"cuda:{torch.cuda.device_count()}"
    with pytest.raises(ValueError, match="mesh device"):
        frame_mesh([absent])
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no CUDA device"):
            frame_mesh()
    with pytest.raises(ValueError, match="no device"):
        frame_mesh([])


def test_replicate_reaches_closures():
    """(e) `_replicate` moves a problem's tensors and a callable prior's
    captured tensors (the horse's, a closure) to the shard's device."""
    from moshpp_torch.priors.mahalanobis import MahalanobisPrior, horse_prior
    fields = {f: torch.zeros(2, 2) for f in
              MahalanobisPrior.__dataclass_fields__}
    rows = horse_prior(MahalanobisPrior(**fields))
    moved = stageii._replicate(rows, torch.device("meta"))
    (cell,) = moved.__closure__
    assert all(getattr(cell.cell_contents, f).device.type == "meta"
               for f in fields)
    assert rows.__closure__[0].cell_contents.mean.device.type == "cpu"


def test_launch_counts_survive_threads():
    """(e) the shards' threads count their kernels' launches into one
    `kernels.COUNTS`: 32 threads (more than this host's cores) with a
    shortened switch interval lose no update."""
    import threading
    from moshpp_torch import kernels
    n_threads, n = 32, 2000

    def work():
        for _ in range(n):
            kernels.count_launch("stress", frames=7)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        kernels.COUNTS.reset()
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert kernels.COUNTS.launches["stress"] == n_threads * n
        assert kernels.COUNTS.frames[("stress", 7)] == n_threads * n
    finally:
        sys.setswitchinterval(saved)
        kernels.COUNTS.reset()
