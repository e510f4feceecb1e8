"""The port's CLI (`python -m moshpp_torch`) and fleet, with `--device cpu`:
the mirror of tests/test_cli.py and tests/test_fleet.py (override parsing,
config mapping, the device flag, each subcommand, the fleet's filtering,
failure isolation and multi-pass draining), plus real runs of the head on
tests/test_head.py's world: `run` and `run-many` (two spawned workers), and
all six subcommands in a process where JAX, the JAX package and PyYAML
cannot be imported.
"""

import json
import os
import pickle

import numpy as np
import pytest

from moshpp_torch import cli
from moshpp_torch.io.mocap import write_mocap_c3d
from moshpp_torch.pipeline import fleet
import subprocess
import sys

from torch_head_common import (BLOCK_JAX_AND_YAML, base_overrides,
                               build_world)

import moshpp_torch.pipeline.head as head
import torch

torch.set_num_threads(1)
TESTS = os.path.dirname(os.path.abspath(__file__))
# spawned workers and fresh interpreters: one thread each
ONE_THREAD = dict(os.environ, OMP_NUM_THREADS="1")


def test_parse_overrides_yaml_typing():
    out = cli._parse_overrides([
        "opt_settings.maxiter=50",
        "mocap.ds_rate=2",
        "moshpp.optimize_betas=false",
        "surface_model.type=smplx",
        "moshpp.pose_hand_prior_fname=null",
        "opt_settings.e_3=0.01",
        "opt_settings.stagei_lr=1e-3",
        "mocap.rotate=[90, 0, 0]",
        "mocap.exclude_markers=",
    ])
    assert out["opt_settings.maxiter"] == 50
    assert out["mocap.ds_rate"] == 2
    assert out["moshpp.optimize_betas"] is False
    assert out["surface_model.type"] == "smplx"
    assert out["moshpp.pose_hand_prior_fname"] is None
    assert out["opt_settings.e_3"] == pytest.approx(0.01)
    assert out["opt_settings.stagei_lr"] == "1e-3"     # YAML 1.1, as PyYAML
    assert out["mocap.rotate"] == [90, 0, 0]
    assert out["mocap.exclude_markers"] is None
    with pytest.raises(SystemExit):
        cli._parse_overrides(["no_equals_sign"])
    with pytest.raises(SystemExit):
        cli._parse_overrides(["a.b=- x"])


def _fake_run(seen, result):
    def run(cfg, *, device):
        seen.update(cfg, device=device)
        return result
    return run


def test_run_maps_flags_to_cfg(monkeypatch):
    seen = {}

    class _FakeMoSh:
        stagei_fname = "/w/x_stagei.pkl"
        stageii_data = None

    monkeypatch.setattr(head, "run_moshpp_once", _fake_run(seen, _FakeMoSh()))
    rc = cli.main([
        "run", "/d/DS/S1/seq.c3d", "--work-dir", "/w", "--support-dir", "/s",
        "--model-type", "smplx", "--stagei-only", "--device", "cpu",
        "-o", "opt_settings.maxiter=7", "-o", "mocap.ds_rate=3",
    ])
    assert rc == 0
    assert seen["mocap.fname"] == "/d/DS/S1/seq.c3d"
    assert seen["dirs.work_base_dir"] == "/w"
    assert seen["dirs.support_base_dir"] == "/s"
    assert seen["surface_model.type"] == "smplx"
    assert seen["runtime.stagei_only"] is True
    assert seen["opt_settings.maxiter"] == 7
    assert seen["mocap.ds_rate"] == 3
    assert seen["device"] == "cpu"
    seen.clear()
    cli.main(["run", "/d/DS/S1/seq.c3d"])
    assert seen["device"] == "cuda"          # the default: the card


def test_info_subcommand(tmp_path, capsys):
    rng = np.random.default_rng(3)
    F, M = 25, 6
    markers = rng.normal(size=(F, M, 3)).astype(np.float32) * 0.4
    markers[5:9, 2] = np.nan                     # a dropout window
    labels = [f"MK{i}" for i in range(M)]
    fname = str(tmp_path / "seq.c3d")
    write_mocap_c3d(markers, labels, fname, frame_rate=60)

    rc = cli.main(["info", fname, "--labels"])
    assert rc == 0
    info = json.loads(capsys.readouterr().out)
    assert info["num_frames"] == F
    assert info["num_markers"] == M
    assert info["frame_rate"] == 60.0
    assert info["time_length_s"] == pytest.approx(F / 60.0)
    assert info["labels"] == labels
    assert 0.5 < info["mean_marker_availability"] < 1.0


def _tiny_stageii_pkl(tmp_path):
    F, M = 10, 5
    rng = np.random.default_rng(0)
    data = {
        "markers_latent": rng.normal(size=(M, 3)).astype(np.float32),
        "latent_labels": [f"MK{i}" for i in range(M)],
        "markers_latent_vids": np.arange(M),
        "trans": rng.normal(size=(F, 3)).astype(np.float32),
        "fullpose": rng.normal(size=(F, 156)).astype(np.float32) * 0.1,
        "betas": rng.normal(size=16).astype(np.float32),
        "stagei_debug_details": {},
        "stageii_debug_details": {
            "mocap_frame_rate": 120.0,
            "mocap_time_length": F / 120.0,
            "cfg": {
                "surface_model": {"gender": "neutral", "type": "smplh",
                                  "num_betas": 16, "fname": "model.npz"},
                "moshpp": {"optimize_betas": True, "optimize_dynamics": False,
                           "optimize_face": False},
            },
        },
    }
    fname = str(tmp_path / "seq_stageii.pkl")
    with open(fname, "wb") as f:
        pickle.dump(data, f)
    return fname


def test_export_subcommand(tmp_path, capsys):
    pkl = _tiny_stageii_pkl(tmp_path)
    out_npz = str(tmp_path / "seq.npz")
    rc = cli.main(["export", pkl, "-O", out_npz])
    assert rc == 0
    assert "wrote" in capsys.readouterr().out
    npz = np.load(out_npz, allow_pickle=True)
    assert npz["poses"].shape == (10, 156)
    assert npz["trans"].shape == (10, 3)
    assert npz["betas"].shape == (16,)
    assert npz["pose_body"].shape == (10, 63)
    assert str(npz["surface_model_type"]) == "smplh"
    assert (tmp_path / "neutral_stagei.npz").exists()


def test_view_subcommand(tmp_path, capsys):
    rng = np.random.default_rng(5)
    markers = rng.normal(size=(12, 4, 3)).astype(np.float32) * 0.3
    fname = str(tmp_path / "clip.c3d")
    write_mocap_c3d(markers, ["A", "B", "C", "D"], fname, frame_rate=120)
    out = str(tmp_path / "clip.html")
    rc = cli.main(["view", fname, "-O", out])
    assert rc == 0
    html = open(out).read()
    assert "<canvas" in html and '"labels"' in html


def test_layout_subcommand(tmp_path, capsys):
    rng = np.random.default_rng(6)
    M = 5
    stagei = {
        "markers_latent": rng.normal(size=(M, 3)).astype(np.float32),
        "latent_labels": [f"MK{i}" for i in range(M)],
        "markers_latent_vids": np.arange(M),
        "betas": rng.normal(size=16).astype(np.float32),
        "marker_meta": {
            "marker_vids": {f"MK{i}": i for i in range(M)},
            "marker_type_mask": {"body": np.ones(M, bool)},
            "m2b_distance": {"body": 0.0095},
            "surface_model_type": "smplh",
        },
        "stagei_debug_details": {
            "cfg": {"surface_model": {"fname": "/nonexistent/model.npz",
                                      "type": "smplh", "num_betas": 16}},
        },
    }
    pkl = str(tmp_path / "subj_stagei.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(stagei, f)
    out = str(tmp_path / "layout.json")
    rc = cli.main(["layout", pkl, "-O", out, "--device", "cpu"])
    assert rc == 0
    meta = json.load(open(out))
    assert [m["type"] for m in meta["markersets"]] == ["body"]


# ---- the fleet (tests/test_fleet.py) ----------------------------------------

def _world(tmp_path, n_seqs=3):
    sess = tmp_path / "DS" / "S1"
    sess.mkdir(parents=True)
    (sess / "settings.json").write_text('{"gender": "neutral"}')
    rng = np.random.default_rng(0)
    fnames = []
    for i in range(n_seqs):
        markers = rng.normal(size=(4, 3, 3)).astype(np.float32)
        f = str(sess / f"seq{i}.c3d")
        write_mocap_c3d(markers, ["A", "B", "C"], f, frame_rate=60)
        fnames.append(f)
    return fnames


def _base(tmp_path):
    return {
        "dirs.work_base_dir": str(tmp_path / "work"),
        "dirs.support_base_dir": str(tmp_path / "support"),
        "surface_model.type": "smplh",
    }


def test_fleet_runs_and_isolates_failures(tmp_path, monkeypatch):
    fnames = _world(tmp_path)
    calls = []

    class _FakeMoSh:
        stageii_fname = "/w/out_stageii.pkl"

    def fake_run(cfg, *, device):
        assert device == "cpu"
        calls.append(cfg["mocap.fname"])
        if "seq1" in cfg["mocap.fname"]:
            raise RuntimeError("boom")
        return _FakeMoSh()

    monkeypatch.setattr(head, "run_moshpp_once", fake_run)
    jobs = [{**_base(tmp_path), "mocap.fname": f} for f in fnames]
    rep = fleet.run_moshpp_fleet(jobs, device="cpu")
    assert len(calls) == 3
    assert rep.num_ok == 2 and rep.num_failed == 1

    jobs = [{**_base(tmp_path), "mocap.fname": f,
             "moshpp.perseq_mosh_stagei": True} for f in fnames]
    calls.clear()
    rep = fleet.run_moshpp_fleet(jobs, device="cpu")
    assert len(calls) == 3
    assert rep.num_ok == 2
    assert rep.num_failed == 1
    failed = [r for r in rep.results if r.status == "failed"]
    assert "boom" in failed[0].error
    assert "ok" in rep.summary()


def test_fleet_stop_on_error(tmp_path, monkeypatch):
    fnames = _world(tmp_path)

    def fake_run(cfg, *, device):
        raise RuntimeError("always")

    monkeypatch.setattr(head, "run_moshpp_once", fake_run)
    jobs = [{**_base(tmp_path), "mocap.fname": f,
             "moshpp.perseq_mosh_stagei": True} for f in fnames]
    rep = fleet.run_moshpp_fleet(jobs, stop_on_error=True, device="cpu")
    assert rep.num_failed == 1
    assert rep.num_pending == 2
    assert "not attempted" in rep.summary()


def test_fleet_skips_completed(tmp_path, monkeypatch):
    from moshpp_torch.config.config import prepare_cfg
    fnames = _world(tmp_path, n_seqs=2)
    cfg0 = prepare_cfg(**{**_base(tmp_path), "mocap.fname": fnames[0]})
    os.makedirs(os.path.dirname(cfg0["dirs.stageii_fname"]), exist_ok=True)
    open(cfg0["dirs.stageii_fname"], "wb").close()
    open(cfg0["dirs.stagei_fname"], "wb").close()
    calls = []

    class _FakeMoSh:
        stageii_fname = None

    def fake_run(cfg, *, device):
        calls.append(cfg["mocap.fname"])
        return _FakeMoSh()

    monkeypatch.setattr(head, "run_moshpp_once", fake_run)
    jobs = [{**_base(tmp_path), "mocap.fname": f,
             "moshpp.perseq_mosh_stagei": True} for f in fnames]
    rep = fleet.run_moshpp_fleet(jobs, device="cpu")
    assert calls == [fnames[1]]
    assert rep.num_filtered == 1 and rep.num_ok == 1


def test_fleet_multipass_unblocks_deferred_siblings(tmp_path, monkeypatch):
    from moshpp_torch.config.config import prepare_cfg
    fnames = _world(tmp_path)
    calls = []

    class _FakeMoSh:
        stageii_fname = None

    def fake_run(cfg_dict, *, device):
        calls.append(cfg_dict["mocap.fname"])
        cfg = prepare_cfg(**cfg_dict)
        for k in ("dirs.stagei_fname", "dirs.stageii_fname"):
            os.makedirs(os.path.dirname(cfg[k]), exist_ok=True)
            open(cfg[k], "wb").close()
        return _FakeMoSh()

    monkeypatch.setattr(head, "run_moshpp_once", fake_run)
    jobs = [{**_base(tmp_path), "mocap.fname": f} for f in fnames]
    rep = fleet.run_moshpp_fleet(jobs, device="cpu")
    assert len(calls) == 3
    assert rep.num_ok == 3 and rep.num_failed == 0
    calls.clear()
    rep2 = fleet.run_moshpp_fleet(jobs, device="cpu")
    assert calls == []
    assert rep2.num_filtered == 3


def test_cli_run_many_passes_the_device(tmp_path, monkeypatch, capsys):
    _world(tmp_path)
    seen = []

    class _FakeMoSh:
        stageii_fname = None

    def fake_run(cfg, *, device):
        seen.append(device)
        return _FakeMoSh()

    monkeypatch.setattr(head, "run_moshpp_once", fake_run)
    rc = cli.main([
        "run-many", str(tmp_path / "DS" / "S1" / "*.c3d"),
        "--work-dir", str(tmp_path / "work"),
        "--support-dir", str(tmp_path / "support"),
        "--model-type", "smplh", "--per-seq-shape", "--device", "cpu",
        "-o", "opt_settings.maxiter=5",
    ])
    out = capsys.readouterr().out
    assert rc == 0
    assert "3 ok, 0 failed" in out
    assert seen == ["cpu"] * 3


def _overrides_as_flags(over: dict) -> list:
    flags = []
    for k, v in over.items():
        if k != "mocap.fname":
            flags += ["-o", f"{k}={'null' if v is None else v}"]
    return flags


def test_cli_run_and_run_many_for_real(tmp_path, capsys, monkeypatch):
    """`run` solves stage i and ii of one C3D on the CPU and exports the
    npz; `run-many` then finds the first cached and solves the second
    with the cached stage i, in two spawned worker processes."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    w = build_world(tmp_path / "world")
    over = base_overrides(w, tmp_path / "work")
    npz = str(tmp_path / "seq0.npz")
    rc = cli.main(["run", w["seq_fnames"][0], "--device", "cpu", "--npz", npz,
                   *_overrides_as_flags(over)])
    out = capsys.readouterr().out
    assert rc == 0 and "mean data err" in out
    assert np.load(npz)["poses"].shape == (8, 156)
    rc = cli.main(["run-many", *w["seq_fnames"], "--device", "cpu",
                   "--processes", "2", *_overrides_as_flags(over)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "1 ok, 0 failed, 1 filtered/cached of 2" in out
    for f in w["seq_fnames"]:
        name = os.path.basename(f).replace(".c3d", "_stageii.pkl")
        assert os.path.exists(tmp_path / "work" / "SynthDS" / "Subject0"
                              / name)
    # a job that fails in a worker is reported once and not retried (the
    # JAX fleet tells attempted jobs by the identity of the workers' copies,
    # so it would run this one again on every pass)
    missing = os.path.join(os.path.dirname(w["seq_fnames"][0]), "gone.c3d")
    jobs = [dict(over, **{"mocap.fname": f})
            for f in (*w["seq_fnames"], missing)]
    rep = fleet.run_moshpp_fleet(jobs, processes=2, device="cpu")
    assert (rep.num_ok, rep.num_failed, rep.num_filtered) == (0, 1, 2)
    assert "gone.c3d" in [r for r in rep.results
                          if r.status == "failed"][0].error


_SIX = BLOCK_JAX_AND_YAML + """
import json, os, sys
sys.path.insert(0, sys.argv[2])
import torch
torch.set_num_threads(1)
from moshpp_torch import cli
from torch_head_common import base_overrides, build_world
root = sys.argv[1]
w = build_world(os.path.join(root, "world"))
flags = []
for k, v in base_overrides(w, os.path.join(root, "work")).items():
    if k != "mocap.fname":
        flags += ["-o", f"{k}={'null' if v is None else v}"]
seq0, seq1 = w["seq_fnames"]
work = os.path.join(root, "work", "SynthDS", "Subject0")
npz = os.path.join(root, "seq0.npz")
for argv in (["run", seq0, "--device", "cpu", "--npz", npz, *flags],
             ["run-many", seq0, seq1, "--device", "cpu", *flags],
             ["export", os.path.join(work, "seq1_stageii.pkl"), "-O",
              os.path.join(root, "seq1.npz")],
             ["layout", os.path.join(work, "neutral_stagei.pkl"), "-O",
              os.path.join(root, "layout.json"), "--device", "cpu"],
             ["view", seq0, "-O", os.path.join(root, "seq0.html")],
             ["info", seq1]):
    assert cli.main(argv) == 0, argv
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "moshpp_tpu", "yaml"))
assert not bad, bad
print("SIX OK")
"""


def test_six_subcommands_without_jax_or_yaml(tmp_path):
    """Every subcommand, through the head, the fleet and the exporters, in a
    fresh interpreter that refuses JAX, the JAX package and PyYAML."""
    r = subprocess.run([sys.executable, "-c", _SIX, str(tmp_path), TESTS],
                       cwd=os.path.dirname(TESTS), capture_output=True,
                       text=True, timeout=600, env=ONE_THREAD)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "SIX OK" in r.stdout
    for f in ("seq0.npz", "seq1.npz", "layout.json", "seq0.html"):
        assert (tmp_path / f).exists(), f
    assert np.load(tmp_path / "seq1.npz")["poses"].shape == (8, 156)
