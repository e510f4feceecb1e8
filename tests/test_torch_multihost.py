"""The port's multi-process stage ii (`moshpp_torch.parallel.multihost`) on
the CPU: two processes over gloo, port code only, solve
tests/test_multihost.py's world (16 frames, 8 a process) with
`mosh_stageii_solve_multihost`, and their gathered frames meet phase 3's
gate of chip_smoke.py (mean marker error within 0.02 mm, wander within
0.6 mm) against the single-process 2-shard solve; the mean error stays
under tests/test_multihost.py's 5 mm; the system probe on the group's
mesh equals the one-process probe; `distribute_jobs` gives every job to
exactly one process. Each process runs under a timeout."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from moshpp_torch.parallel import distribute_jobs, frame_mesh
from moshpp_torch.pipeline import stageii
from torch_parallel_common import MULTIHOST_WORKER, multihost_world

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
PROCESSES = 2
TIMEOUT_S = 300
PARITY_MEAN_MM, PARITY_WANDER_MM = 0.02, 0.6


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' saved results (started together, each killed at
    TIMEOUT_S)."""
    tmp = tmp_path_factory.mktemp("multihost")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    outs = [str(tmp / f"rank{r}.npz") for r in range(PROCESSES)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", MULTIHOST_WORKER, str(r), str(PROCESSES),
         str(port), TESTS, REPO, outs[r]], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(PROCESSES)]
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [dict(np.load(o)) for o in outs]


def test_two_processes_match_two_shards(ranks):
    torch.set_num_threads(1)
    prob, opts, obs, mask = multihost_world()
    ref = stageii.mosh_stageii_solve(prob, opts, obs, mask,
                                     model_type="smplh", device="cpu",
                                     mesh=frame_mesh(["cpu"] * 2))
    sim = np.concatenate([r["markers_sim"] for r in ranks])
    err = np.concatenate([r["data_err"] for r in ranks])
    assert sim.shape == tuple(ref.markers_sim.shape)
    d_mean = abs(err.mean() - ref.data_err.numpy().mean()) * 1e3
    wander = np.abs(sim - ref.markers_sim.numpy()).max() * 1e3
    assert d_mean <= PARITY_MEAN_MM and wander <= PARITY_WANDER_MM, (
        d_mean, wander)
    for r in ranks:
        assert r["data_err"].mean() * 1e3 < 5.0
        assert str(r["backend"]) == "gloo" and int(r["shards"]) == PROCESSES


def test_probe_over_processes_matches_unsharded(ranks):
    """`stageii_system_probe` on the group's mesh (each rank assembles its
    shard, the frames gathered over gloo) equals the one-process probe on
    every rank, max|diff| / max|unsharded| <= 1e-5 for f, g and B
    (__graft_entry__.py:155-160)."""
    prob, opts, obs, mask = multihost_world()
    ref = stageii.stageii_system_probe(prob, opts, obs, mask,
                                       model_type="smplh")
    for r in ranks:
        for name, b in zip("fgB", ref):
            a = torch.as_tensor(r[f"probe_{name}"])
            assert a.shape == b.shape, name
            rel = float((a - b).abs().max() / b.abs().max())
            assert rel <= 1e-5, (name, rel)


def test_jobs_partition_exactly(ranks):
    jobs = sorted(int(j) for r in ranks for j in r["jobs"])
    assert jobs == [0, 1, 2, 3, 4]
    assert [list(r["jobs"]) for r in ranks] == [[0, 2, 4], [1, 3]]


def test_distribute_jobs_without_a_group():
    """Outside a process group a process is rank 0 of 1 unless told."""
    jobs = [{"job": i} for i in range(7)]
    assert distribute_jobs(jobs) == jobs
    assert distribute_jobs(jobs, 2, 3) == [jobs[2], jobs[5]]


def test_multihost_needs_a_group():
    from moshpp_torch.parallel import (global_frame_mesh,
                                       mosh_stageii_solve_multihost)
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        global_frame_mesh()
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        mosh_stageii_solve_multihost(None, None, np.zeros((2, 1, 3)),
                                     np.ones((2, 1), bool), device="cpu")
