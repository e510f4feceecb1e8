"""The port's file formats against the JAX package's, on the same inputs.

C3D files written by each package and read by the other (points bit for
bit, the two writers' bytes equal, with and without the native codec);
`MocapSession` on c3d, npz, pkl and mat with units, rotation, subject
selection and marker exclusion (equal to 0); `load_surface_model` on a
synthetic npz and on a chumpy-style pkl with the hand-PCA and DMPL splices
(every array equal to 0); both AMASS exporters on the same pickles (key for
key, equal to 0).
"""

import pickle
import sys
import types

import numpy as np
import pytest

from moshpp_tpu.io import amass as jax_amass
from moshpp_tpu.io import c3d as jax_c3d
from moshpp_tpu.io import mocap as jax_mocap
from moshpp_tpu.io import model_loader as jax_loader

from moshpp_torch import native
from moshpp_torch.io import amass, c3d, mocap, model_loader
from moshpp_torch.io.ply import write_ply
from moshpp_torch.models.synthetic import (make_synthetic_model,
                                           save_synthetic_npz)

_MODEL_FIELDS = ("v_template", "shapedirs", "posedirs", "weights",
                 "joint_template", "joint_shapedirs", "hands_components",
                 "hands_mean", "faces")


def _points(F=37, M=9, seed=0):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(F, M, 3)) * 400.0).astype(np.float32)
    pts[rng.uniform(size=(F, M)) < 0.15] = np.nan
    return pts


@pytest.fixture(params=["native", "numpy"])
def codec(request, monkeypatch):
    """The port's C3D paths: the native codec, or its numpy fallback."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "decode_points", lambda *a, **k: None)
        monkeypatch.setattr(native, "encode_points", lambda *a, **k: None)
    else:
        assert native.native_available()
    return request.param


def test_c3d_cross_read_and_same_bytes(tmp_path, codec):
    pts = _points()
    labels = [f"MK{i}" for i in range(pts.shape[1])]
    fj, ft = str(tmp_path / "jax.c3d"), str(tmp_path / "torch.c3d")
    jax_c3d.write_c3d(fj, pts, labels, frame_rate=120.0)
    c3d.write_c3d(ft, pts, labels, frame_rate=120.0)
    with open(fj, "rb") as a, open(ft, "rb") as b:
        assert a.read() == b.read()
    for src in (fj, ft):
        mine, ref = c3d.read_c3d(src), jax_c3d.read_c3d(src)
        assert mine.decoder == codec
        np.testing.assert_array_equal(mine.points, ref.points)
        np.testing.assert_array_equal(mine.points, pts)
        np.testing.assert_array_equal(mine.residuals, ref.residuals)
        assert mine.labels == ref.labels and mine.frame_rate == ref.frame_rate


def _session_files(tmp_path):
    """One capture of two subjects (S1, S2) with a starred autolabel, in all
    four containers; mm."""
    rng = np.random.default_rng(3)
    F = 23
    labels = ["S1:LFHD", "S1:RFHD", "S1:C7", "S2:LFHD", "S2:RFHD", "S2:C7",
              "S1:*7", "S2:STRN"]
    pts = (rng.normal(size=(F, len(labels), 3)) * 300.0).astype(np.float32)
    pts[rng.uniform(size=pts.shape[:2]) < 0.1] = np.nan
    out = {}
    out["c3d"] = str(tmp_path / "cap.c3d")
    jax_c3d.write_c3d(out["c3d"], pts, labels, frame_rate=100.0)
    p64 = pts.astype(np.float64)
    out["npz"] = str(tmp_path / "cap.npz")
    np.savez(out["npz"], markers=p64, labels=labels, frame_rate=100.0)
    out["pkl"] = str(tmp_path / "cap.pkl")
    with open(out["pkl"], "wb") as f:
        pickle.dump({"markers": p64, "labels": labels, "frame_rate": 100.0}, f)
    import scipy.io
    out["mat"] = str(tmp_path / "cap.mat")
    scipy.io.savemat(out["mat"], {"MoCaps": p64,
                                  "Labels": np.array([labels], dtype=object)})
    return out


@pytest.mark.parametrize("fmt", ["c3d", "npz", "pkl", "mat"])
@pytest.mark.parametrize("kw", [
    dict(mocap_unit="mm"),
    dict(mocap_unit="cm", mocap_rotate=[90, 0, 30]),
    dict(mocap_unit="mm", only_subjects=["S2"], exclude_markers=["C7"]),
    dict(mocap_unit="m", only_subjects=["S1", "S2"],
         labels_map={"LFHD": "LFHead"}),
], ids=["mm", "cm_rotate", "subject_exclude", "m_labels_map"])
def test_mocap_session_matches_jax(tmp_path, fmt, kw):
    fname = _session_files(tmp_path)[fmt]
    mine, ref = mocap.MocapSession(fname, **kw), jax_mocap.MocapSession(fname, **kw)
    np.testing.assert_array_equal(mine.markers, ref.markers)
    assert mine.labels == ref.labels
    assert mine.subject_names == ref.subject_names
    assert mine.frame_rate == ref.frame_rate
    assert mine.multi_subject == ref.multi_subject
    assert sorted(mine.subject_mask) == sorted(ref.subject_mask)
    for k in ref.subject_mask:
        np.testing.assert_array_equal(mine.subject_mask[k], ref.subject_mask[k])
    want = ref.labels[::-1] + ["absent"]
    for a, b in zip(mine.markers_for_labels(want), ref.markers_for_labels(want)):
        np.testing.assert_array_equal(a, b)


def test_write_mocap_c3d_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    m = rng.normal(size=(11, 5, 3)) * 0.4
    m[2, 1] = 0.0
    m[3, 2] = np.nan
    labels = list("ABCDE")
    a, b = str(tmp_path / "a.c3d"), str(tmp_path / "b.c3d")
    mocap.write_mocap_c3d(m, labels, a, frame_rate=60)
    jax_mocap.write_mocap_c3d(m, labels, b, frame_rate=60)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def _assert_model_equal(arrays, jmodel):
    for f in _MODEL_FIELDS:
        np.testing.assert_array_equal(arrays[f], np.asarray(getattr(jmodel, f)),
                                      err_msg=f)
    for f in ("model_type", "parents", "num_betas", "dof_per_hand", "skin_k"):
        assert arrays[f] == getattr(jmodel, f), f


def test_load_surface_model_synthetic_npz(tmp_path):
    model = make_synthetic_model("smplh", num_verts=300, dof_per_hand=6,
                                 seed=5, device="cpu")
    path = str(tmp_path / "model.npz")
    save_synthetic_npz(model, path)
    dmpl = str(tmp_path / "dmpl.npz")
    np.savez(dmpl, eigvec=np.random.default_rng(1).normal(
        size=(model.v_template.shape[0], 3, 12)).astype(np.float32))
    for kw in (dict(num_betas=16), dict(num_betas=10, dmpl_fname=dmpl,
                                         num_dmpls=8)):
        arrays = model_loader.load_surface_model_arrays(path, **kw)
        _assert_model_equal(arrays, jax_loader.load_surface_model(path, **kw))
    loaded = model_loader.load_surface_model(path, num_betas=16, device="cpu")
    for f in _MODEL_FIELDS:
        np.testing.assert_array_equal(getattr(loaded, f).numpy(),
                                      getattr(model, f).numpy(), err_msg=f)


def test_load_surface_model_chumpy_pkl(tmp_path):
    """An official-style smplh pkl: chumpy arrays, a J_regressor, hands from
    a pose_hand_prior npz, the DMPL splice from a pkl, v_template from a
    PLY."""
    rng = np.random.default_rng(2)
    sm = make_synthetic_model("smplh", num_verts=200, seed=4, device="cpu")
    V, J = sm.v_template.shape[0], sm.num_joints
    ch_mod = types.ModuleType("chumpy")

    class Ch:
        def __init__(self, x):
            self.x = np.asarray(x)

    Ch.__module__ = "chumpy"
    Ch.__qualname__ = "Ch"
    ch_mod.Ch = Ch
    sys.modules["chumpy"] = ch_mod
    try:
        jreg = rng.uniform(size=(J, V))
        d = dict(v_template=Ch(sm.v_template.numpy()),
                 shapedirs=Ch(sm.shapedirs.numpy()),
                 posedirs=sm.posedirs.numpy(), weights=sm.weights.numpy(),
                 J_regressor=jreg / jreg.sum(1, keepdims=True),
                 f=sm.faces.numpy(),
                 kintree_table=np.vstack([
                     np.array([p if p >= 0 else 2 ** 32 - 1 for p in sm.parents]),
                     np.arange(J)]))
        path = str(tmp_path / "model.pkl")
        with open(path, "wb") as fh:
            pickle.dump(d, fh)
    finally:
        del sys.modules["chumpy"]
    hands = str(tmp_path / "hands.npz")
    np.savez(hands, componentsl=rng.normal(size=(45, 45)),
             componentsr=rng.normal(size=(45, 45)),
             hands_meanl=rng.normal(size=45), hands_meanr=rng.normal(size=45))
    dmpl = str(tmp_path / "dmpl.pkl")
    with open(dmpl, "wb") as fh:
        pickle.dump({"eigvec": rng.normal(size=(V, 3, 8))}, fh)
    ply = str(tmp_path / "vt.ply")
    write_ply(ply, sm.v_template.numpy() * 1.1, sm.faces.numpy())
    kw = dict(pose_hand_prior_fname=hands, use_hands_mean=True,
              dof_per_hand=9, num_betas=12, dmpl_fname=dmpl, num_dmpls=8,
              v_template_fname=ply)
    arrays = model_loader.load_surface_model_arrays(path, **kw)
    assert arrays["model_type"] == "smplh"
    _assert_model_equal(arrays, jax_loader.load_surface_model(path, **kw))


def _stageii_pickle(dmpls: bool, face: bool) -> dict:
    rng = np.random.default_rng(0)
    F, M = 10, 5
    data = {
        "markers_latent": rng.normal(size=(M, 3)).astype(np.float32),
        "latent_labels": [f"MK{i}" for i in range(M)],
        "markers_latent_vids": {f"MK{i}": i for i in range(M)},
        "trans": rng.normal(size=(F, 3)).astype(np.float32),
        "fullpose": rng.normal(size=(F, 165 if face else 156)).astype(np.float32),
        "betas": rng.normal(size=16).astype(np.float32),
        "marker_meta": {"marker_vids": {f"MK{i}": i for i in range(M)}},
        "stagei_debug_details": {"v_template": rng.normal(size=(7, 3))},
        "stageii_debug_details": {
            "mocap_frame_rate": 120.0, "mocap_time_length": F / 120.0,
            "markers_orig": rng.normal(size=(F, M + 1, 3)),
            "labels_orig": [f"MK{i}" for i in range(M + 1)],
            "markers_obs": rng.normal(size=(F, M, 3)),
            "labels_obs": [[f"MK{i}" for i in range(M)]] * F,
            "markers_sim": rng.normal(size=(F, M, 3)).astype(np.float32),
            "cfg": {
                "surface_model": {"gender": "female",
                                  "type": "smplx" if face else "smplh",
                                  "num_betas": 10, "num_dmpls": 4,
                                  "num_expressions": 6, "fname": "m.npz"},
                "moshpp": {"optimize_betas": True, "optimize_dynamics": dmpls,
                           "optimize_face": face},
            },
        },
    }
    if dmpls:
        data["dmpls"] = rng.normal(size=(F, 8)).astype(np.float32)
    if face:
        data["expression"] = rng.normal(size=(F, 20)).astype(np.float32)
    return data


def _legacy_pickle() -> dict:
    rng = np.random.default_rng(1)
    F, M = 6, 4
    return {
        "ps": {"gender": "male", "fitting_model": "smplh", "betas": None,
               "num_betas": 10, "use_dynamics": True, "num_dmpls": 8,
               "optimize_face": False, "num_expr": 0},
        "mocap_framerate": 60.0, "mocap_timelength": F / 60.0,
        "shape_est_lmrks": rng.normal(size=(M, 3)),
        "shape_est_lmlabels": [f"MK{i}" for i in range(M)],
        "shape_debug_details": {"shape_est_lmrks_vids": list(range(M))},
        "shape_est_betas": rng.normal(size=16),
        "pose_est_trans": rng.normal(size=(F, 3)),
        "pose_est_fullposes": rng.normal(size=(F, 156)),
        "pose_est_dmpls": rng.normal(size=(F, 8)),
    }


def _assert_same(a, b, path="out"):
    if isinstance(b, dict):
        assert isinstance(a, dict) and sorted(a) == sorted(b), path
        for k in b:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, path


@pytest.mark.parametrize("dmpls,face", [(False, False), (True, False),
                                        (False, True)],
                         ids=["plain", "dmpls", "face"])
def test_amass_export_matches_jax(tmp_path, dmpls, face):
    data = _stageii_pickle(dmpls, face)
    pkl = str(tmp_path / "seq_stageii.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(data, f)
    outs = {}
    for name, mod in (("torch", amass), ("jax", jax_amass)):
        d = tmp_path / name
        outs[name] = mod.load_as_amass_npz(
            pkl, stageii_npz_fname=str(d / "seq.npz"), include_markers=True,
            include_extra_details=True)
    _assert_same(outs["torch"], outs["jax"])
    for fn in ("seq.npz", "female_stagei.npz"):
        a = np.load(tmp_path / "torch" / fn, allow_pickle=True)
        b = np.load(tmp_path / "jax" / fn, allow_pickle=True)
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_amass_export_with_dropouts(tmp_path):
    """A capture with dropouts: each frame's observed labels differ in
    number. The JAX exporter's np.savez raises on them; the port stores
    them as an object array, and both return the same data."""
    data = _stageii_pickle(False, False)
    dbg = data["stageii_debug_details"]
    dbg["labels_obs"] = [dbg["labels_obs"][0][:5 - (f % 3)]
                         for f in range(10)]
    out = str(tmp_path / "seq.npz")
    with pytest.raises(ValueError):
        jax_amass.load_as_amass_npz(data, stageii_npz_fname=str(
            tmp_path / "jax" / "seq.npz"), include_markers=True)
    mine = amass.load_as_amass_npz(data, stageii_npz_fname=out,
                                   include_markers=True)
    _assert_same(mine, jax_amass.load_as_amass_npz(data,
                                                   include_markers=True))
    z = np.load(out, allow_pickle=True)
    assert [list(l) for l in z["labels_obs"]] == dbg["labels_obs"]
    np.testing.assert_array_equal(z["poses"], data["fullpose"])


def test_amass_legacy_export_matches_jax(tmp_path):
    data = _legacy_pickle()
    outs = {name: mod.load_as_amass_npz_legacy(
        data, stageii_npz_fname=str(tmp_path / name / "seq.npz"))
        for name, mod in (("torch", amass), ("jax", jax_amass))}
    _assert_same(outs["torch"], outs["jax"])
    for part in ("root_orient", "pose_body", "pose_hand"):
        np.testing.assert_array_equal(
            amass.turn_fullpose_into_parts(data["pose_est_fullposes"],
                                           "smplh")[part],
            jax_amass.turn_fullpose_into_parts(data["pose_est_fullposes"],
                                               "smplh")[part])
