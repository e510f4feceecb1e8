"""AMASS-format export (port of `moshpp_tpu/io/amass.py`, numpy; reference:
`mosh_head.py:444-541`, `tools/run_tools.py:70-85`): turn stage-ii results into the npz schema the
AMASS tooling ecosystem consumes (gender / surface_model_type / trans /
poses / betas / dmpls / expression / pose parts / optional markers)."""

from __future__ import annotations

import os
import pickle
from pathlib import Path
from typing import Optional, Union

import numpy as np


def turn_fullpose_into_parts(fullpose: np.ndarray, surface_model_type: str) -> dict:
    """Slice (F, 3J) fullpose into the named AMASS pose parts
    (run_tools.py:70-85)."""
    res = {"root_orient": fullpose[:, :3]}
    if "smpl" in surface_model_type:
        res["pose_body"] = fullpose[:, 3:66]
    elif any(t in surface_model_type for t in ("animal", "object")):
        res["pose_body"] = fullpose[:, 3:]
    if "smplh" in surface_model_type:
        res["pose_hand"] = fullpose[:, 66:]
    elif "smplx" in surface_model_type:
        res["pose_hand"] = fullpose[:, 75:]
        res["pose_jaw"] = fullpose[:, 66:69]
        res["pose_eye"] = fullpose[:, 69:75]
    elif "mano" in surface_model_type:
        res["pose_hand"] = fullpose[:, 3:]
    return res


def _makepath(fname: str) -> str:
    d = os.path.dirname(os.path.abspath(fname))
    os.makedirs(d, exist_ok=True)
    return fname


def _savez(fname: str, **arrays) -> None:
    """np.savez, with a ragged sequence (`labels_obs`: each frame's observed
    labels, of as many entries as markers were seen) stored as a 1-D object
    array of its items. np.savez alone raises on it, as the JAX package's
    exporter does for any capture with a dropout and `include_markers`."""
    out = {}
    for k, v in arrays.items():
        try:
            out[k] = np.asanyarray(v)
        except ValueError:
            out[k] = np.empty(len(v), dtype=object)
            out[k][:] = list(v)
    np.savez(_makepath(fname), **out)


def load_as_amass_npz_legacy(stageii_pkl_data_or_fname: Union[dict, str, Path],
                             stageii_npz_fname: Optional[Union[str, Path]] = None,
                             stagei_npz_fname: Optional[Union[str, Path]] = None,
                             include_markers: bool = False) -> dict:
    """Convert a *legacy* (py2-era) MoSh stage-ii pickle to AMASS npz data.

    Mirrors `mosh_head.py:342-441`: the legacy schema keeps a flat config
    under `ps` (gender / fitting_model / betas / use_dynamics / ...) and
    stage outputs under `shape_est_*` / `pose_est_*` keys. Pickles are
    decoded latin-1 (py2 byte strings).
    """
    if isinstance(stageii_pkl_data_or_fname, dict):
        data = stageii_pkl_data_or_fname
    else:
        with open(stageii_pkl_data_or_fname, "rb") as f:
            data = pickle.load(f, encoding="latin-1")

    cfg = data["ps"]
    out = {
        "gender": cfg["gender"],
        "surface_model_type": cfg["fitting_model"],
        "mocap_frame_rate": data["mocap_framerate"],
        "mocap_time_length": data["mocap_timelength"],
        "markers_latent": data["shape_est_lmrks"],
        "latent_labels": data["shape_est_lmlabels"],
        "markers_latent_vids": data["shape_debug_details"]["shape_est_lmrks_vids"],
        "trans": data["pose_est_trans"],
        "poses": data["pose_est_fullposes"],
    }
    if "vtemplate_fname" in data:
        from moshpp_torch.io.ply import read_ply
        out["v_template"] = read_ply(data["vtemplate_fname"])[0]
        out["v_template_fname"] = data["vtemplate_fname"]

    optimize_betas = ("vtemplate_fname" not in data) and (cfg["betas"] is None)
    if optimize_betas:
        num_betas = cfg["num_betas"]
        out["betas"] = np.asarray(data["shape_est_betas"])[:num_betas]
        out["num_betas"] = num_betas
    if cfg["use_dynamics"]:
        num_dmpls = cfg["num_dmpls"]
        out["dmpls"] = np.asarray(data["pose_est_dmpls"])[:, :num_dmpls]
        out["num_dmpls"] = num_dmpls
    if cfg["optimize_face"]:
        num_expr = cfg["num_expr"]
        out["expression"] = np.asarray(data["pose_est_exprs"])[:, :num_expr]
        out["num_expressions"] = num_expr

    out.update(turn_fullpose_into_parts(
        np.asarray(data["pose_est_fullposes"]), cfg["fitting_model"]))

    if include_markers:
        from moshpp_torch.markers.layout import marker_layout_load
        out["markers"] = data["pose_est_obmrks"]
        out["labels"] = data["pose_est_mrk_labels"]
        out["markers_obs"] = data["pose_est_obmrks"]
        out["labels_obs"] = data["pose_est_mrk_labels"]
        out["markers_sim"] = data["pose_est_simmrks"]
        out["marker_meta"] = marker_layout_load(
            cfg["mrk_settings_fname"], only_markers=data["shape_est_lmlabels"])
        out["num_markers"] = np.asarray(out["markers"]).shape[1]

    if stageii_npz_fname:
        stageii_npz_fname = str(stageii_npz_fname)
        if not os.path.exists(stageii_npz_fname):
            _savez(stageii_npz_fname, **out)
        if stagei_npz_fname is None:
            stagei_npz_fname = os.path.join(
                os.path.dirname(stageii_npz_fname),
                f"{cfg['gender']}_stagei.npz")
        stagei_npz_fname = str(stagei_npz_fname)
        if not os.path.exists(stagei_npz_fname):
            keep = ["gender", "surface_model_type", "markers_latent",
                    "latent_labels", "markers_latent_vids", "betas",
                    "v_template"]
            _savez(stagei_npz_fname,
                   **{k: v for k, v in out.items() if k in keep})
    return out


def load_as_amass_npz(stageii_pkl_data_or_fname: Union[dict, str, Path],
                      stageii_npz_fname: Optional[Union[str, Path]] = None,
                      stagei_npz_fname: Optional[Union[str, Path]] = None,
                      include_markers: bool = False,
                      include_extra_details: bool = False) -> dict:
    """Convert a stage-ii result pickle (or dict) to AMASS npz data, writing
    the npz files when output paths are given (mosh_head.py:444-541)."""
    if isinstance(stageii_pkl_data_or_fname, dict):
        data = stageii_pkl_data_or_fname
    else:
        with open(stageii_pkl_data_or_fname, "rb") as f:
            data = pickle.load(f)

    dbg = data["stageii_debug_details"]
    cfg = dbg["cfg"]

    sm = cfg["surface_model"]
    out = {
        "gender": sm["gender"],
        "surface_model_type": sm["type"],
        "mocap_frame_rate": dbg["mocap_frame_rate"],
        "mocap_time_length": dbg["mocap_time_length"],
        "markers_latent": data["markers_latent"],
        "latent_labels": data["latent_labels"],
        "markers_latent_vids": data["markers_latent_vids"],
        "trans": data["trans"],
        "poses": data["fullpose"],
    }
    if include_extra_details:
        out["surface_model_fname"] = sm["fname"]
    if "v_template" in data.get("stagei_debug_details", {}):
        out["v_template"] = data["stagei_debug_details"]["v_template"]

    mp = cfg["moshpp"]
    if mp.get("optimize_betas") and data.get("betas") is not None:
        out["betas"] = np.asarray(data["betas"])[: sm["num_betas"]]
        out["num_betas"] = sm["num_betas"]
    if mp.get("optimize_dynamics") and "dmpls" in data:
        out["dmpls"] = np.asarray(data["dmpls"])[:, : sm["num_dmpls"]]
        out["num_dmpls"] = sm["num_dmpls"]
    if mp.get("optimize_face") and "expression" in data:
        out["expression"] = np.asarray(data["expression"])[:, : sm["num_expressions"]]
        out["num_expressions"] = sm["num_expressions"]

    out.update(turn_fullpose_into_parts(np.asarray(data["fullpose"]), sm["type"]))

    if include_markers:
        out["markers"] = dbg["markers_orig"]
        out["labels"] = dbg["labels_orig"]
        out["markers_obs"] = dbg["markers_obs"]
        out["labels_obs"] = dbg["labels_obs"]
        out["markers_sim"] = dbg["markers_sim"]
        out["marker_meta"] = data["marker_meta"]
        out["num_markers"] = np.asarray(out["markers"]).shape[1]

    if stageii_npz_fname:
        stageii_npz_fname = str(stageii_npz_fname)
        if not os.path.exists(stageii_npz_fname):
            _savez(stageii_npz_fname, **out)
        if stagei_npz_fname is None:
            stagei_npz_fname = os.path.join(
                os.path.dirname(stageii_npz_fname), f"{sm['gender']}_stagei.npz")
        stagei_npz_fname = str(stagei_npz_fname)
        if not os.path.exists(stagei_npz_fname):
            keep = ["gender", "surface_model_type", "markers_latent",
                    "latent_labels", "markers_latent_vids", "betas", "v_template"]
            _savez(stagei_npz_fname,
                   **{k: v for k, v in out.items() if k in keep})
    return out
