"""The port's marker tables and layouts against the JAX package's, exactly.

The data files (label -> vertex tables, aliases, SMPL-H <-> SMPL-X maps) are
copies; layouts load, write (byte for byte), filter, merge, remap between
SMPL-H and SMPL-X and autogenerate from labels as in the JAX package; the
head's layout inspection files (PLY and C3D) hold the JAX package's marker
positions (float32 forward models: within 1e-5 m).
"""

import filecmp
import os

import numpy as np
import pytest

from moshpp_tpu.markers import autogen as jax_autogen
from moshpp_tpu.markers import layout as jax_layout
from moshpp_tpu.markers import vids as jax_vids
from moshpp_tpu.models.synthetic import save_synthetic_npz as jax_save_npz
from moshpp_tpu.models import make_synthetic_model as jax_make_model
from moshpp_tpu.tools import visualization as jax_vis

from moshpp_torch.markers import autogen, layout, vids
from moshpp_torch.tools import visualization

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# vendor aliases, an unknown label, face, finger and wrist labels
LABELS = ["HEAD_TOP", "L_ANKLE", "RWRA", "LWRB", "C7", "NOSUCHLABEL", "LANK",
          "RANK", "STRN", "LTHMB", "RIDX3", "LEYE", "REYE", "RFHD", "LFHD"]


@pytest.mark.parametrize("name", ["labels_map.json", "marker_type_labels.json",
                                  "marker_vids.json",
                                  "smplh_smplx_vid_map.npz"])
def test_data_files_are_copies(name):
    assert filecmp.cmp(os.path.join(REPO, "moshpp_tpu", "data", name),
                       os.path.join(REPO, "moshpp_torch", "data", name),
                       shallow=False)


def test_tables_and_vid_maps():
    assert dict(vids.all_marker_vids.items()) == dict(
        jax_vids.all_marker_vids.items())
    assert dict(vids.marker_type_labels) == dict(jax_vids.marker_type_labels)
    assert dict(vids.general_labels_map) == dict(jax_vids.general_labels_map)
    ids = list(range(0, 6890, 97))
    assert vids.smplh2smplx_vids(ids) == jax_vids.smplh2smplx_vids(ids)
    assert vids.smplh2smplx_vids(123) == jax_vids.smplh2smplx_vids(123)
    xids = list(range(0, 10475, 131))
    assert vids.smplx2smplh_vids(xids) == jax_vids.smplx2smplh_vids(xids)
    for n in (10475, 6890):
        np.testing.assert_array_equal(vids.smplx_eyeball_mask(n),
                                      jax_vids.smplx_eyeball_mask(n))


def _same_meta(a, b):
    assert list(a) == list(b)
    for k in b:
        if k == "marker_type_mask":
            assert list(a[k]) == list(b[k])
            for t in b[k]:
                np.testing.assert_array_equal(a[k][t], b[k][t])
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("family,kw", [
    ("smpl", {}), ("smplh", {}), ("smplx", {}),
    ("smplx", dict(wrist_markers_on_stick=True)),
    ("smplh", dict(separate_types=["body"])),
], ids=["smpl", "smplh", "smplx", "smplx_wrist", "smplh_body_only"])
def test_autogen_and_load_match_jax(tmp_path, family, kw):
    a, b = str(tmp_path / "torch.json"), str(tmp_path / "jax.json")
    _same_meta(autogen.marker_labels_to_marker_layout(LABELS, a, family, **kw),
               jax_autogen.marker_labels_to_marker_layout(LABELS, b, family,
                                                          **kw))
    assert filecmp.cmp(a, b, shallow=False)
    for lkw in ({}, dict(labels_map=vids.general_labels_map),
                dict(exclude_markers=["C7"], exclude_marker_types=["face"]),
                dict(only_markers=["LANK", "RANK", "ARIEL"],
                     include_nan=False)):
        mine = layout.marker_layout_load(a, **lkw)
        _same_meta(mine, jax_layout.marker_layout_load(a, **lkw))
        ra, rb = layout.layout_arrays(mine), jax_layout.layout_arrays(mine)
        assert ra["labels"] == rb["labels"]
        for k in ("vids", "m2b"):
            np.testing.assert_array_equal(ra[k], rb[k])


def test_write_filter_merge_remap(tmp_path):
    f1, f2 = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    autogen.marker_labels_to_marker_layout(LABELS[:8], f1, "smplh")
    autogen.marker_labels_to_marker_layout(LABELS[5:], f2, "smplh")
    meta = layout.marker_layout_load(f1)
    # write: the same bytes
    wa, wb = str(tmp_path / "wa.json"), str(tmp_path / "wb.json")
    layout.marker_layout_write(meta, wa)
    jax_layout.marker_layout_write(meta, wb)
    assert filecmp.cmp(wa, wb, shallow=False)
    # filter
    keep = ["ARIEL", "LANK", "RWRA"]
    _same_meta(layout.marker_meta_filter(meta, keep),
               jax_layout.marker_meta_filter(meta, keep))
    # merge (into a file each)
    ma, mb = str(tmp_path / "ma.json"), str(tmp_path / "mb.json")
    _same_meta(layout.merge_marker_layouts([f1, f2], out_fname=ma),
               jax_layout.merge_marker_layouts([f1, f2], out_fname=mb))
    assert filecmp.cmp(ma, mb, shallow=False)
    # remaps, both ways, single vids and lists
    x, xj = (layout.marker_meta_smplh2smplx(meta),
             jax_layout.marker_meta_smplh2smplx(meta))
    _same_meta(x, xj)
    _same_meta(layout.marker_meta_smplx2smplh(x),
               jax_layout.marker_meta_smplx2smplh(xj))
    merged = layout.marker_layout_load(ma)
    _same_meta(layout.marker_meta_smplh2smplx(merged),
               jax_layout.marker_meta_smplh2smplx(merged))


def test_layout_inspection_files_match_jax(tmp_path):
    """`marker_layout_as_mesh` and `marker_layout_to_c3d` (the head's PLY and
    C3D beside the optimized layout) on a synthetic SMPL+H with betas."""
    model = jax_make_model("smplh", num_verts=300, dof_per_hand=6, seed=3)
    mfile = str(tmp_path / "model.npz")
    jax_save_npz(model, mfile)
    lfile = str(tmp_path / "layout.json")
    rng = np.random.default_rng(0)
    V = model.v_template.shape[0]
    layout.marker_layout_write({
        "marker_vids": {f"M{i}": int(v) for i, v in
                        enumerate(rng.choice(V, 9, replace=False))},
        "marker_type_mask": {"body": np.ones(9, bool)},
        "m2b_distance": {"body": 0.0095},
        "surface_model_type": "smplh"}, lfile)
    parms = {"betas": rng.normal(size=16) * 0.3}
    mine = visualization.marker_layout_as_mesh(
        mfile, body_parms=parms, surface_model_type="smplh",
        device="cpu")(lfile, str(tmp_path / "torch.ply"))
    ref = jax_vis.marker_layout_as_mesh(
        mfile, body_parms=parms, surface_model_type="smplh")(
        lfile, str(tmp_path / "jax.ply"))
    assert mine["labels"] == ref["labels"]
    np.testing.assert_allclose(mine["markers"], ref["markers"], atol=1e-5)
    np.testing.assert_allclose(mine["body_verts"], ref["body_verts"],
                               atol=1e-5)
    np.testing.assert_array_equal(mine["body_faces"], ref["body_faces"])
    from moshpp_torch.io.c3d import read_c3d
    visualization.marker_layout_to_c3d(lfile, mfile, "smplh",
                                       str(tmp_path / "torch.c3d"),
                                       device="cpu")
    jax_vis.marker_layout_to_c3d(lfile, mfile, "smplh",
                                 str(tmp_path / "jax.c3d"))
    a, b = read_c3d(str(tmp_path / "torch.c3d")), read_c3d(
        str(tmp_path / "jax.c3d"))
    assert a.points.shape == b.points.shape == (100, 9, 3)
    np.testing.assert_allclose(a.points, b.points, atol=1e-2)   # mm


def test_play_and_snapshot_writers(tmp_path):
    rng = np.random.default_rng(1)
    m = rng.normal(size=(6, 4, 3)).astype(np.float32)
    a = visualization.play_mocap_trajectories(m, str(tmp_path / "a.html"),
                                              labels=list("ABCD"))
    b = jax_vis.play_mocap_trajectories(m, str(tmp_path / "b.html"),
                                        labels=list("ABCD"))
    assert filecmp.cmp(a, b, shallow=False)
    hook = visualization.phase_snapshot_writer(str(tmp_path / "snaps"))
    hook("step1", m[:, 0], m)
    hook("polish", m[:, 1], m)
    assert sorted(os.listdir(tmp_path / "snaps")) == ["01_step1.npz",
                                                     "02_polish.npz"]


def test_randomize_matches_jax(tmp_path):
    """`markers/randomize.py` against the JAX package's: the adjacency, the
    n-ring neighbours, and the draws of one seed (plain and superset
    layouts, face and hand markers kept in place)."""
    from moshpp_tpu.markers import randomize as jax_randomize
    from moshpp_torch.markers import (find_vertex_neighbours,
                                      randomize_marker_layout_vids,
                                      vertex_adjacency)
    m = jax_make_model("smpl", num_verts=200, seed=12)
    path = str(tmp_path / "m.npz")
    jax_save_npz(m, path)
    faces, V = np.asarray(m.faces), m.v_template.shape[0]
    assert vertex_adjacency(faces, V) == jax_randomize.vertex_adjacency(faces,
                                                                        V)
    mine = find_vertex_neighbours(path)
    theirs = jax_randomize.find_vertex_neighbours(path)
    for vid in (0, 5, 50, V - 1):
        for n_ring in (0, 1, 2, 3):
            assert mine(vid, n_ring) == theirs(vid, n_ring), (vid, n_ring)
    for marker_vids, kw in (
            ({"A": 5, "B": 50, "C": 120}, {}),
            ({"A": [5, 7], "B": [50]}, dict(n_ring=2)),
            ({"A": 5, "B": 50, "C": 120},
             dict(enable_rnd_vid_on_face_hands=False))):
        mask = {"body": [True, False, True][:len(marker_vids)]}
        a = randomize_marker_layout_vids(marker_vids, mask, path, seed=3, **kw)
        b = jax_randomize.randomize_marker_layout_vids(marker_vids, mask, path,
                                                       seed=3, **kw)
        for _ in range(6):
            assert a() == b()
    with pytest.raises(ValueError, match="body"):
        randomize_marker_layout_vids({"A": 5}, {}, path,
                                     enable_rnd_vid_on_face_hands=False)
