"""The port's head (`moshpp_torch.pipeline.head`) against the JAX package's,
on tests/test_head.py's world (320-vertex SMPL+H, 14 markers, two 18-frame
C3Ds; `maxiter` 25, one sweep, 8 frames), on the CPU.

The JAX head runs in a fresh interpreter started as the module begins: its
stage i and stage ii from the C3D files, then its stage ii on its own
stage-i pickle with the observations as they are and moved by 1e-7 m for
ten seeds (the floor of `torch_families_common.check_solve`). Meanwhile
the port's head runs on the same files. Then:
  - stage i reads the same files and picks the same frames;
  - the pickles of both packages have one schema (keys, types, dtypes and
    shapes, recursively), and the port's hold no tensor;
  - each package reads the other's pickles (the head's caches, the AMASS
    exporters; the exporters' outputs equal);
  - the port's stage ii on JAX's stage-i pickle against JAX's stage ii, by
    `check_solve`'s gates (mean marker error within 0.1 mm; the fitted
    markers and trans within max(tolerance, 1.5 x JAX's floor));
  - `mosh_stageii_solve` called on the head's inputs gives the head's
    result bit for bit; the caches skip both solves (patched solvers
    that raise); the stage-i files of a session with more files than
    frames are drawn from the frame picker's seed.
"""

import json
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from moshpp_tpu.io import amass as jax_amass
from moshpp_tpu.pipeline import head as jax_head

from moshpp_torch.io import amass
from moshpp_torch.io.mocap import write_mocap_c3d
from moshpp_torch.pipeline import head
from moshpp_torch.pipeline.stageii import mosh_stageii_solve
from torch_families_common import JAX_SEEDS, check_solve, perturbed
from torch_head_common import base_overrides, build_world

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)


def jax_head_runs(overrides: dict) -> dict:
    """The JAX head on the world: stage i and ii (`run_moshpp_once`), then
    its stage ii again on its own stage-i pickle for the floor, through the
    head's solver hook: {seed: data_err, markers_sim, trans} and the
    observations the head built (numpy)."""
    from moshpp_tpu.pipeline.stageii import mosh_stageii_solve as jax_solve
    mp = jax_head.run_moshpp_once(dict(overrides))
    seen = {}

    def floor(prob, opts, obs, mask, **kw):
        seen.update(obs=obs, mask=mask)
        out, res = {}, {}
        for seed in JAX_SEEDS:
            res[seed] = jax_solve(prob, opts, perturbed(obs, seed), mask, **kw)
            out[seed] = {k: np.asarray(getattr(res[seed], k))
                         for k in ("data_err", "markers_sim", "trans")}
        seen["solves"] = out
        return res[None]

    again = jax_head.MoSh(**overrides)
    again.stageii_fname = again.stageii_fname.replace(".pkl", "_floor.pkl")
    again.mosh_stagei()
    again.mosh_stageii(mosh_stageii_func=floor)
    return dict(stagei_fname=mp.stagei_fname, stageii_fname=mp.stageii_fname,
                **seen)


_CHILD = """
import json, os, pickle, sys, tempfile
sys.path.insert(0, sys.argv[3])
sys.path.insert(0, sys.argv[4])
import jax
jax.config.update("jax_platforms", "cpu")
from moshpp_tpu.utils.cache import setup_jax_cache
setup_jax_cache(os.path.join(tempfile.gettempdir(), "moshpp_tpu_jax_cache"))
from test_torch_head import jax_head_runs
with open(sys.argv[2], "wb") as f:
    pickle.dump(jax_head_runs(json.loads(sys.argv[1])), f)
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world, the JAX head started on it in a fresh interpreter, and the
    port's head run on it (work directories `jax` and `port`)."""
    root = tmp_path_factory.mktemp("head_world")
    w = build_world(root)
    out = root / "jax_runs.pkl"
    proc = subprocess.Popen(
        [sys.executable, "-c", _CHILD,
         json.dumps(base_overrides(w, root / "jax")), str(out), REPO, TESTS],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)

    def jax_result() -> dict:
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err.decode()[-2000:]
        with open(out, "rb") as f:
            return pickle.load(f)

    over = base_overrides(w, root / "port")
    mp = head.run_moshpp_once(over, device="cpu")
    yield dict(w, root=root, over=over, mp=mp, jax=jax_result)
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


def _load(fname):
    with open(fname, "rb") as f:
        return pickle.load(f)


def _schema(a, b, path="pkl"):
    """The same keys, types, dtypes and shapes, recursively; the same
    lengths of lists."""
    if isinstance(b, dict):
        assert isinstance(a, dict), path
        assert sorted(a, key=str) == sorted(b, key=str), path
        for k in b:
            _schema(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _schema(x, y, f"{path}[{i}]")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray), (path, type(a))
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                           b.dtype, a.shape,
                                                           b.shape)
    elif b is None:
        assert a is None, path
    else:
        assert type(a) is type(b), (path, type(a), type(b))


def test_stagei_picks_the_same_frames(world):
    mine = _load(world["mp"].stagei_fname)["stagei_debug_details"]
    ref = _load(world["jax"]()["stagei_fname"])["stagei_debug_details"]
    assert mine["stagei_fnames"] == ref["stagei_fnames"]
    assert len(mine["stagei_frames"]) == len(ref["stagei_frames"]) == 3
    for a, b in zip(mine["stagei_frames"], ref["stagei_frames"]):
        assert list(a) == list(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    for a, b in zip(mine["stagei_markers_obs"], ref["stagei_markers_obs"]):
        np.testing.assert_array_equal(a, b)
    assert mine["stagei_labels_obs"] == ref["stagei_labels_obs"]


@pytest.mark.parametrize("stage", ["stagei", "stageii"])
def test_pickle_schemas_match_jax(world, stage):
    jr = world["jax"]()
    mine = _load(getattr(world["mp"], f"{stage}_fname"))
    ref = _load(jr[f"{stage}_fname"])
    _schema(mine, ref)
    cfg_mine = mine["stagei_debug_details"]["cfg"]
    cfg_ref = ref["stagei_debug_details"]["cfg"]
    # the configs differ only in the work directory
    work = lambda c: json.dumps(c, sort_keys=True).replace(
        c["dirs"]["work_base_dir"], "WORK")
    assert work(cfg_mine) == work(cfg_ref)


@pytest.mark.parametrize("stage", ["stagei", "stageii"])
def test_no_tensor_in_pickles(world, stage):
    fname = getattr(world["mp"], f"{stage}_fname")
    with open(fname, "rb") as f:
        assert b"torch" not in f.read()

    def walk(v):
        assert not torch.is_tensor(v)
        if isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
    walk(_load(fname))


def test_each_reads_the_others_pickles(world, tmp_path):
    jr = world["jax"]()
    mine, ref = world["mp"].stageii_fname, jr["stageii_fname"]
    # the exporters, each package on each package's pickle
    for pkl in (mine, ref):
        outs = [mod.load_as_amass_npz(pkl, include_markers=True)
                for mod in (amass, jax_amass)]
        assert sorted(outs[0]) == sorted(outs[1])
        for k, v in outs[1].items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(outs[0][k], v, err_msg=k)
        assert outs[0]["poses"].shape == (8, 156)
    # the JAX head loads the port's caches; the port's head the JAX caches
    def boom(*a, **k):
        raise AssertionError("a cached stage was solved")

    jmp = jax_head.MoSh(**world["over"])
    jmp.mosh_stagei(mosh_stagei_func=boom)
    jmp.mosh_stageii(mosh_stageii_func=boom)
    np.testing.assert_array_equal(jmp.stageii_data["fullpose"],
                                  world["mp"].stageii_data["fullpose"])
    over = dict(world["over"], **{"dirs.work_base_dir": str(world["root"]
                                                            / "jax")})
    tmp = head.MoSh(device="cpu", **over)
    tmp.mosh_stagei(mosh_stagei_func=boom)
    tmp.mosh_stageii(mosh_stageii_func=boom)
    np.testing.assert_array_equal(tmp.stageii_data["fullpose"],
                                  _load(ref)["fullpose"])


def test_stageii_on_jax_stagei_matches_jax(world, tmp_path):
    """The port's head stage ii on a copy of the JAX head's stage-i pickle,
    held to the JAX head's stage ii by `check_solve`'s gates."""
    jr = world["jax"]()
    over = dict(world["over"], **{"dirs.work_base_dir": str(tmp_path)})
    mp = head.MoSh(device="cpu", **over)
    os.makedirs(os.path.dirname(mp.stagei_fname), exist_ok=True)
    shutil.copy(jr["stagei_fname"], mp.stagei_fname)
    mp.mosh_stagei(mosh_stagei_func=lambda *a, **k: 1 / 0)
    inp = mp.stageii_inputs()
    np.testing.assert_array_equal(inp["obs"], jr["obs"])
    np.testing.assert_array_equal(inp["mask"], jr["mask"])
    fp = {"obs": inp["obs"].astype(np.float32), "mask": inp["mask"]}
    problems = {"smplh": (fp, (inp["prob"], inp["opts"], inp["prior"]))}
    check_solve(problems, lambda family: jr["solves"], "smplh")


def test_head_inputs_give_the_heads_result(world):
    """`mosh_stageii_solve` on the inputs the head builds (the port's own
    stage-i pickle) returns the head's stage ii bit for bit."""
    mp = head.MoSh(device="cpu", **world["over"])
    mp.mosh_stagei()
    inp = mp.stageii_inputs()
    res = mosh_stageii_solve(inp["prob"], inp["opts"], inp["obs"],
                             inp["mask"], prior=inp["prior"],
                             model_type=inp["model_type"], device="cpu")
    done = world["mp"].stageii_data
    np.testing.assert_array_equal(res.fullpose.numpy(), done["fullpose"])
    np.testing.assert_array_equal(res.trans.numpy(), done["trans"])
    err = done["stageii_debug_details"]["stageii_errs"]["data_mean_m"]
    assert err.shape == (8,) and err.mean() * 1e3 < 10.0   # tests/test_head.py


def test_cache_skips_the_solves(world, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a cached stage was solved")

    monkeypatch.setattr(head, "mosh_stagei_solve", boom)
    monkeypatch.setattr(head, "mosh_stageii_solve", boom)
    mp = head.run_moshpp_once(world["over"], device="cpu")
    np.testing.assert_array_equal(mp.stageii_data["fullpose"],
                                  world["mp"].stageii_data["fullpose"])
    base = world["mp"].stagei_fname.replace(".pkl", "")
    for ext in (".json", ".ply", ".c3d"):
        assert os.path.exists(base + ext), ext
    npz = str(world["root"] / "out" / "seq0.npz")
    out = head.MoSh.load_as_amass_npz(mp.stageii_fname, stageii_npz_fname=npz)
    assert out["poses"].shape == (8, 156) and os.path.exists(npz)


def test_stagei_files_from_the_seed(tmp_path):
    """A session with more files than `num_frames`: the files stage i reads
    are drawn by `np.random.default_rng(seed)`, the same on every call (the
    JAX head draws from numpy's unseeded global generator)."""
    sess = tmp_path / "DS" / "S1"
    sess.mkdir(parents=True)
    names = [str(sess / f"seq{i}.c3d") for i in range(7)]
    for n in names:
        write_mocap_c3d(np.ones((2, 1, 3)), ["A"], n)
    over = {"mocap.fname": names[0], "dirs.work_base_dir": str(tmp_path),
            "dirs.support_base_dir": str(tmp_path),
            "surface_model.gender": "neutral", "moshpp.verbosity": -1,
            "moshpp.stagei_frame_picker.num_frames": 3}
    def pick(seed):
        return head.MoSh(device="cpu", **over, **{
            "moshpp.stagei_frame_picker.seed": seed}).stagei_mocap_fnames()

    want = [sorted(names)[i] for i in
            np.random.default_rng(100).choice(7, 3, replace=False)]
    assert pick(100) == pick(100) == want
    assert head.MoSh(device="cpu", **over).stagei_mocap_fnames() == want
    assert len(set(pick(7))) == 3


def test_chip_smoke_schema_is_jaxs(world):
    """The key lists `chip_smoke.py` phase 7b holds the card's pickles to
    are the JAX head's."""
    import chip_smoke
    jr = world["jax"]()
    si, sii = _load(jr["stagei_fname"]), _load(jr["stageii_fname"])
    assert tuple(sorted(si)) == chip_smoke.HEAD_STAGEI_KEYS
    assert tuple(sorted(si["stagei_debug_details"])) == \
        chip_smoke.HEAD_STAGEI_DEBUG_KEYS
    assert tuple(sorted(sii)) == tuple(sorted(chip_smoke.HEAD_STAGEII_KEYS))
    assert tuple(sorted(sii["stageii_debug_details"])) == \
        chip_smoke.HEAD_STAGEII_DEBUG_KEYS
