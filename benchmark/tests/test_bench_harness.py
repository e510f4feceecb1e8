"""The harness: cells, configurations, mixes, limits, metrics and counts
found by name; the result line's keys; the trace reductions; the import
guard; no result without a CUDA device."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

import bench_common
from bench_common import BENCH, ROOT, run_tiny, tiny_cell
from harness import trace as tr
from harness.spec import count, load_cell, metric_reader, read_per_layer

FORBIDDEN = {"jax", "jaxlib", "flax", "moshpp_tpu"}


def _bj():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_every_cell_metric_and_count_is_found_by_name():
    bj = _bj()
    for w in bj["workloads"]:
        cell = load_cell(w["name"], BENCH)
        assert cell.config["model_type"] in ("smplh", "smplx")
        assert cell.traffic["frames"] > 0
        assert set(cell.limits) == {"sim_gap_mm", "pose_gap_mrad", "fit_mm",
                                   "marker_fit_mm"}
        assert {m["name"] for m in cell.end_to_end} >= {"frames_per_s",
                                                        "setup_s"}
    for m in bj["per_layer"]:
        assert metric_reader(m["name"], BENCH)({}) is None
    for name in ("marker_rows", "stageii_iteration"):
        assert count(name, BENCH) is not None
    for c in bj["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))


def test_a_file_added_is_found(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    bj = _bj()
    bj["workloads"].append({"name": "smplh.tiny", "config": "smplh_tiny",
                            "traffic": "tiny", "chips": 1, "why": "test"})
    bj["per_layer"].append({"name": "solves_seen", "unit": "solves",
                            "better": "higher", "source": "program_counter",
                            "layer": "whole stage-ii solve",
                            "moves": "frames_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bj))
    cfg = json.loads((root / "configs" / "smplh_body_hands.json").read_text())
    (root / "configs" / "smplh_tiny.json").write_text(json.dumps(
        dict(cfg, num_verts=162)))
    (root / "traffic" / "tiny.json").write_text(json.dumps(
        {"frames": 8, "pool": 1, "observed": 1.0, "motion": {}}))
    (root / "limits" / "smplh.tiny.json").write_text(json.dumps(
        {"sim_gap_mm": 1, "pose_gap_mrad": 1, "fit_mm": 1,
         "marker_fit_mm": 1}))
    (root / "metrics" / "solves_seen.py").write_text(
        "def read(record):\n    s = record.get('solves')\n"
        "    return len(s) if s else None\n")
    cell = load_cell("smplh.tiny", str(root))
    assert cell.config["num_verts"] == 162
    assert cell.traffic["frames"] == 8
    assert [m["name"] for m in cell.per_layer][-1] == "solves_seen"
    got = read_per_layer(cell, {"solves": [{}, {}, {}]})
    assert got["solves_seen"] == {"value": 3.0, "unit": "solves"}
    with pytest.raises(KeyError):
        load_cell("no.such.cell", str(root))


def test_result_line_keys_end_to_end_and_traced():
    cell = tiny_cell()
    res, lines = run_tiny(cell)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["attempted"] == 1
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0 or \
            m["unit"] == "GiB"
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert [ln.split(":")[0] for ln in lines[1:]] == [
        "check sim_gap_mm", "check pose_gap_mrad", "check fit_mm",
        "check marker_fit_mm"]
    json.dumps(res)
    res, _ = run_tiny(cell, traced=True)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks" and "breakdown" in res
    assert res["device"]["window_s"] > 0
    # on the CPU no device events: only the program's counters read
    assert set(res["metrics"]) == {"host_syncs_per_solve", "iters_per_frame"}
    assert res["metrics"]["iters_per_frame"]["value"] > 1


def test_trace_reductions():
    ev = [("k1", 0, 10), ("Memcpy HtoD", 5, 20), ("k2", 30, 40),
          ("k1", 35, 50), ("k3", 70, 80)]
    assert tr.busy_intervals(ev) == [(0, 20), (30, 50), (70, 80)]
    assert tr.busy_seconds(ev, 0, 100) == pytest.approx(50e-9)
    assert tr.busy_seconds(ev, 8, 75) == pytest.approx(37e-9)
    host = [("outer", 0, 100), ("aten::item", 20, 29), ("py", 55, 69)]
    gaps = dict(tr.idle_gaps(ev, host, 0, 100))
    assert gaps == {"aten::item": pytest.approx(10e-9),
                    "py": pytest.approx(20e-9),
                    "outer": pytest.approx(20e-9)}
    assert tr.device_ops(ev)[0] == ["k1", pytest.approx(25e-9)]
    assert not tr.is_kernel("Memset (Device)") and tr.is_kernel("k1")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module.split(".")[0]


def _py_files(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_import_guard_by_whole_top_level_names():
    for p in _py_files(BENCH):
        names = set(_imports(p))
        assert not names & FORBIDDEN, (p, names & FORBIDDEN)
        if os.sep + "reference" + os.sep in p:
            assert "moshpp_torch" not in names, p
    # whole names: the port's name begins with the JAX package's letters
    assert "moshpp_torch".split(".")[0] not in FORBIDDEN
    sys.path.insert(0, BENCH)
    import run
    assert run.loaded_forbidden() == []


def test_no_result_without_a_cuda_device():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                        "--workload", "smplh.capture4k", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_no_result_without_the_program(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "smplh.capture4k", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=tmp_path, timeout=120, env=env)
    assert p.returncode != 0 and p.stdout == ""


assert bench_common.BENCH
