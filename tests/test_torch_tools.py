"""The port's twins of the JAX package's tools and example, on the CPU.

- tools/profile_stageii_torch.py --trace at 16 frames and maxiter 5, run
  with JAX and the JAX package refused: the CSV has the JAX tool's columns
  and one row an iteration;
- tools/bench_stagei_torch.py --scipy-anchor at 2 frames and 3 scipy
  evaluations a step (a 300-vertex model asked), JAX refused: a finite
  anchor error beside the port's own solve;
- examples/synthetic_end_to_end_torch.py's `build_world` writes the JAX
  example's files with the same contents (the C3D markers to 1e-5 m: the
  two forward models round apart). The whole example takes over a minute
  on this CPU, so its < 2 mm bar is checked on the card (chip_smoke.py
  phase 9c).
"""

import importlib.util
import json
import os
import pickle
import subprocess
import sys

import numpy as np

from torch_head_common import BLOCK_JAX_AND_YAML

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tools/profile_stageii.py's columns; the world's terms (SMPL+H with its
# fingers free and the GMM prior), sorted as that tool sorts them
TRACE_COLUMNS = ["iter", "active_frac", "accept_frac", "mean_f", "mean_delta",
                 "data", "poseB", "poseH", "velo"]
C3D_ATOL_M = 1e-5


def _run_without_jax(script, *args, timeout=300):
    """Run a repo script as __main__ in a fresh interpreter that refuses
    JAX, the JAX package and PyYAML; its stdout."""
    code = (BLOCK_JAX_AND_YAML + "import runpy, sys\n"
            f"sys.argv = {[script, *args]!r}\n"
            f"runpy.run_path({script!r}, run_name='__main__')\n")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=timeout, cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def test_profile_trace_csv(tmp_path):
    out = tmp_path / "trace.csv"
    stdout = _run_without_jax(
        os.path.join(REPO, "tools", "profile_stageii_torch.py"),
        "--device", "cpu", "--frames", "16", "--maxiter", "5", "--trace",
        "--trace-out", str(out))
    assert "frames/s" in stdout and "mean marker err" in stdout
    lines = out.read_text().splitlines()
    assert lines[0].split(",") == TRACE_COLUMNS
    rows = [list(map(float, ln.split(","))) for ln in lines[1:]]
    assert len(rows) == 5
    assert [r[0] for r in rows] == [0, 1, 2, 3, 4]
    assert np.isfinite(rows).all()
    assert all(0.0 <= r[1] <= 1.0 and 0.0 <= r[2] <= r[1] for r in rows)


def test_bench_stagei_scipy_anchor():
    stdout = _run_without_jax(
        os.path.join(REPO, "tools", "bench_stagei_torch.py"),
        "--device", "cpu", "--frames", "2", "--maxiter", "3", "--verts",
        "300", "--scipy-anchor", "--max-nfev", "3")
    line = json.loads(stdout.strip().splitlines()[-1])
    assert line["metric"] == "stagei_seconds_per_subject"
    d = line["detail"]
    assert np.isfinite(d["scipy_anchor_err_mm"]) and d["scipy_anchor_err_mm"] > 0
    assert np.isfinite(d["mean_marker_err_mm"])


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_example_world_matches_jax_example(tmp_path):
    from moshpp_torch.io.mocap import read_mocap
    jax_ex = _load(os.path.join(REPO, "examples", "synthetic_end_to_end.py"),
                   "jax_example")
    port_ex = _load(os.path.join(REPO, "examples",
                                 "synthetic_end_to_end_torch.py"),
                    "port_example")
    a, b = tmp_path / "jax", tmp_path / "port"
    poses_a, trans_a = jax_ex.build_world(str(a))
    poses_b, trans_b = port_ex.build_world(str(b))
    np.testing.assert_array_equal(poses_a, poses_b)
    np.testing.assert_array_equal(trans_a, trans_b)
    assert _files(a) == _files(b)
    for rel in ("support/smplh/layout.json",
                "mocap/ExampleDS/Subject1/settings.json"):
        assert json.loads((a / rel).read_text()) == json.loads(
            (b / rel).read_text()), rel
    with open(a / "support/smplh/pose_body_prior.pkl", "rb") as f:
        pa = pickle.load(f)
    with open(b / "support/smplh/pose_body_prior.pkl", "rb") as f:
        pb = pickle.load(f)
    assert sorted(pa) == sorted(pb)
    for k in pa:
        np.testing.assert_array_equal(np.asarray(pa[k]), np.asarray(pb[k]))
    with np.load(a / "support/smplh/model.npz") as za, \
            np.load(b / "support/smplh/model.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            if za[k].dtype.kind in "fiu":
                np.testing.assert_allclose(zb[k], za[k], atol=1e-6,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(zb[k], za[k], err_msg=k)
    # the raw read is in the file's unit, mm
    ma = read_mocap(str(a / "mocap/ExampleDS/Subject1/seq.c3d"))
    mb = read_mocap(str(b / "mocap/ExampleDS/Subject1/seq.c3d"))
    assert list(ma["labels"]) == list(mb["labels"])
    np.testing.assert_allclose(mb["markers"], ma["markers"],
                               atol=C3D_ATOL_M * 1e3)
