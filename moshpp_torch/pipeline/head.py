"""MoSh session head: config-driven end-to-end pipeline with filesystem
caching (port of `moshpp_tpu/pipeline/head.py`; reference:
`mosh_head.py:65-341, 584-606`).

Keeps the reference's public surface — `MoSh(**cfg)` / `prepare_cfg` /
`mosh_stagei()` / `mosh_stageii()` / `run_moshpp_once(cfg)` — and its on-disk
artifacts: `<subject>_stagei.pkl`, `<basename>_stageii.pkl` with the JAX
package's key schema, the optimized marker-layout JSON with its PLY/C3D
inspection files, and AMASS npz export (`io/amass.load_as_amass_npz`).
Stage results are cached by path and idempotently skipped.

The solves run on `device` ("cuda" unless the caller asks for the CPU); the
pickles hold numpy arrays and plain Python, never tensors, so that each
package's cache and exporters read the other's.

One deliberate difference from the JAX head: when a session holds more
mocap files than `stagei_frame_picker.num_frames`, the files stage i reads
are drawn by a generator seeded from `stagei_frame_picker.seed`, not by
numpy's unseeded global generator, so a rerun picks the same files.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import pickle
import shutil
import time
from glob import glob

import numpy as np
import torch

from moshpp_torch.config.config import Config, prepare_cfg
from moshpp_torch.io.amass import load_as_amass_npz, load_as_amass_npz_legacy
from moshpp_torch.io.mocap import MocapSession
from moshpp_torch.io.model_loader import load_surface_model
from moshpp_torch.markers.autogen import marker_labels_to_marker_layout
from moshpp_torch.markers.layout import (layout_arrays, marker_layout_load,
                                         marker_layout_write)
from moshpp_torch.markers.vids import general_labels_map
from moshpp_torch.pipeline import frame_picker
from moshpp_torch.pipeline.frame_picker import frames_to_arrays
from moshpp_torch.pipeline.stagei import StageIOptions, mosh_stagei_solve
from moshpp_torch.pipeline.stageii import (StageIIOptions, mosh_stageii_solve,
                                           prepare_stageii_problem)
from moshpp_torch.priors.gmm import load_gmm_prior
from moshpp_torch.utils.logging import get_logger, set_log_file


def _makepath(fname: str) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(fname)), exist_ok=True)
    return fname


def _np(t) -> np.ndarray:
    """A tensor (on any device) as a numpy array."""
    return t.detach().cpu().numpy()


def _weights_table(cfg: Config) -> dict:
    wt_type = cfg.get("opt_settings.weights_type", cfg["surface_model.type"])
    table = cfg["opt_weights"].get(wt_type)
    if table is None:
        table = cfg["opt_weights.smplh"]
    return {k: (v if not hasattr(v, "to_dict") else v.to_dict())
            for k, v in table.items()}


def _stagei_weights(cfg: Config) -> dict:
    t = _weights_table(cfg)
    return {k[len("stagei_wt_"):]: v for k, v in t.items() if k.startswith("stagei_wt_")}


def _stageii_weights(cfg: Config) -> dict:
    t = _weights_table(cfg)
    return {k[len("stageii_wt_"):]: v for k, v in t.items() if k.startswith("stageii_wt_")}


class MoSh:
    """Flexible-input session wrapper around the stage-i/ii solvers, which
    run on `device`."""

    def __init__(self, dict_cfg=None, *, device="cuda", **kwargs) -> None:
        self.cfg = MoSh.prepare_cfg(dict_cfg=dict_cfg, **kwargs)
        self.device = torch.device(device)
        cfg = self.cfg
        self.logger = get_logger()

        if cfg["moshpp.verbosity"] > 0:
            prefix = f"{cfg['mocap.session_name']} -- {cfg['mocap.basename']}"
            if cfg["mocap.multi_subject"]:
                prefix += f" -- {cfg['mocap.subject_name']}"
            set_log_file(_makepath(cfg["dirs.log_fname"]), prefix=prefix)

        self.stagei_fname = cfg["dirs.stagei_fname"]
        self.stageii_fname = cfg["dirs.stageii_fname"]
        self.stagei_data = None
        self.stageii_data = None

        if cfg["moshpp.verbosity"] < 0:
            return  # status-only call

        if not os.path.exists(cfg["surface_model.fname"]):
            raise FileNotFoundError(
                f"surface_model.fname not found: {cfg['surface_model.fname']}")
        self.logger.info("mocap_fname: %s", cfg["mocap.fname"])
        self.logger.info("stagei_fname: %s", self.stagei_fname)
        self.logger.info("stageii_fname: %s", self.stageii_fname)

    # ------------------------------------------------------------------ cfg
    @staticmethod
    def prepare_cfg(dict_cfg=None, **kwargs) -> Config:
        return prepare_cfg(dict_cfg=dict_cfg, **kwargs)

    # ------------------------------------------------------------- stage I
    def _mocap_filters(self) -> dict:
        cfg = self.cfg
        return dict(
            mocap_unit=cfg["mocap.unit"],
            mocap_rotate=cfg.get("mocap.rotate"),
            only_subjects=([cfg["mocap.subject_name"]]
                           if cfg["mocap.multi_subject"] else None),
            labels_map=general_labels_map)

    def stagei_mocap_fnames(self) -> list:
        """The session's sibling mocap files stage i reads: all of them, or
        `num_frames` of them drawn by a generator seeded from the frame
        picker's seed when there are more."""
        cfg = self.cfg
        fp_cfg = cfg["moshpp.stagei_frame_picker"]
        base = os.path.dirname(cfg["mocap.fname"])
        ext = os.path.basename(cfg["mocap.fname"]).split(".")[-1]
        fnames = sorted(glob(os.path.join(base, f"*.{ext}")))
        if not fnames:
            raise FileNotFoundError(f"no sibling mocaps found in {base}")
        n = fp_cfg["num_frames"]
        if len(fnames) > n:
            ids = np.random.default_rng(fp_cfg["seed"]).choice(
                len(fnames), n, replace=False)
            fnames = [fnames[i] for i in ids]
        return fnames

    def prepare_stagei_frames(self, stagei_mocap_fnames=None):
        cfg = self.cfg
        fp_cfg = cfg["moshpp.stagei_frame_picker"]
        kind = fp_cfg["type"]
        if stagei_mocap_fnames is None:
            if kind == "manual":
                raise ValueError(
                    "manual frame picking needs explicit mocap_frameid entries")
            stagei_mocap_fnames = self.stagei_mocap_fnames()

        common = dict(self._mocap_filters(),
                      only_markers=cfg.get("mocap.only_markers"),
                      exclude_markers=cfg.get("mocap.exclude_markers"))
        if kind == "random":
            return frame_picker.load_marker_sessions_random(
                stagei_mocap_fnames, num_frames=fp_cfg["num_frames"],
                seed=fp_cfg["seed"],
                least_avail_markers=fp_cfg["least_avail_markers"], **common)
        if kind == "random_strict":
            return frame_picker.load_marker_sessions_random_strict(
                stagei_mocap_fnames, num_frames=fp_cfg["num_frames"],
                seed=fp_cfg["seed"],
                least_avail_markers=fp_cfg["least_avail_markers"], **common)
        if kind == "manual":
            return frame_picker.load_marker_sessions_manual(
                stagei_mocap_fnames, **common)
        raise ValueError(f"unknown frame picker type: {kind}")

    def _load_model(self):
        cfg = self.cfg
        if cfg["surface_model.type"] == "object":
            from moshpp_torch.models.object_model import (
                load_rigid_object, object_as_surface_model)
            return object_as_surface_model(
                load_rigid_object(cfg["surface_model.fname"],
                                  device=self.device))
        hand_prior = cfg.get("moshpp.pose_hand_prior_fname")
        if hand_prior and not os.path.exists(hand_prior):
            hand_prior = None
        dmpl_fname = None
        if cfg["moshpp.optimize_dynamics"]:
            if cfg["surface_model.type"] not in ("smpl", "smplh"):
                raise ValueError(
                    "DMPLs are only supported by smpl and smplh models")
            dmpl_fname = cfg.get("surface_model.dmpl_fname")
            if dmpl_fname and not os.path.exists(dmpl_fname):
                self.logger.warning("dmpl_fname not found: %s", dmpl_fname)
                dmpl_fname = None
        return load_surface_model(
            cfg["surface_model.fname"],
            surface_model_type=cfg["surface_model.type"],
            pose_hand_prior_fname=hand_prior,
            use_hands_mean=cfg.get("surface_model.use_hands_mean", False),
            dof_per_hand=cfg.get("surface_model.dof_per_hand", 12),
            num_betas=cfg["surface_model.num_betas"],
            v_template_fname=cfg.get("moshpp.v_template_fname"),
            dmpl_fname=dmpl_fname,
            num_dmpls=cfg.get("surface_model.num_dmpls", 8),
            device=self.device,
        )

    def _load_pose_prior(self, model_type: str):
        cfg = self.cfg
        fname = cfg.get("moshpp.pose_body_prior_fname")
        if not fname or not os.path.exists(fname):
            self.logger.warning("pose body prior not found (%s); solving without", fname)
            return None
        if model_type == "animal_horse":
            # Mahalanobis prior + leg joint-angle penalty at 2x weight
            # (chmosh.py:356-358, 615-617)
            from moshpp_torch.priors.mahalanobis import (horse_prior,
                                                         load_horse_prior)
            return horse_prior(load_horse_prior(fname, device=self.device))
        if model_type == "animal_dog":
            # max-mixture GMM over the 31-joint subset the dog model
            # articulates (dog_body_prior.py:47-58); the solver applies it to
            # pose[body_ids], which for animal_dog is exactly DOG_POSE_IDS
            from moshpp_torch.priors.mahalanobis import (DOG_POSE_IDS,
                                                         load_dog_prior)
            dog = load_dog_prior(fname, device=self.device)
            if dog.dim != len(DOG_POSE_IDS):
                raise ValueError(f"dog prior dim {dog.dim} != "
                                 f"{len(DOG_POSE_IDS)} selected dofs")
            return dog
        # exclude hands from the body prior for the hand-PCA families
        # (gmm_prior_ch.py:116)
        npose = 63 if model_type in ("smplh", "smplx") else None
        return load_gmm_prior(fname, npose=npose, device=self.device)

    def mosh_stagei(self, mosh_stagei_func=None) -> str:
        """Run (or load cached) stage-i. `mosh_stagei_func` optionally
        replaces the solver callable (`mosh_stagei_solve` signature,
        `device=` included) — the reference's injection pattern
        (mosh_head.py:200)."""
        solve = mosh_stagei_func or mosh_stagei_solve
        cfg = self.cfg
        if os.path.exists(self.stagei_fname):
            with open(self.stagei_fname, "rb") as f:
                self.stagei_data = pickle.load(f)
            prev = self.stagei_data["stagei_debug_details"]["cfg"]["surface_model"]["fname"]
            if prev != cfg["surface_model.fname"]:
                raise ValueError(
                    f"cached stage-i used a different surface model: {prev}")
            self.logger.info("loaded cached stage-i: %s", self.stagei_fname)
            return self.stagei_fname

        tm = time.time()
        stagei_frames, stagei_fnames = self.prepare_stagei_frames(
            cfg.get("moshpp.stagei_frame_picker.stagei_mocap_fnames"))

        layout_fname = cfg["dirs.marker_layout.fname"]
        if not os.path.exists(layout_fname):
            chosen = sorted({k for fr in stagei_frames for k in fr})
            marker_labels_to_marker_layout(
                chosen_markers=chosen,
                marker_layout_fname=_makepath(layout_fname),
                surface_model_type=cfg["surface_model.type"],
                labels_map=general_labels_map,
                wrist_markers_on_stick=cfg.get("moshpp.wrist_markers_on_stick", False),
                separate_types=cfg.get("moshpp.separate_types"),
            )

        marker_meta = marker_layout_load(
            layout_fname, labels_map=general_labels_map, include_nan=True,
            exclude_markers=cfg.get("mocap.exclude_markers"),
            exclude_marker_types=cfg.get("mocap.exclude_marker_types"),
            only_markers=cfg.get("mocap.only_markers"))
        arrays = layout_arrays(marker_meta)
        if marker_meta["surface_model_type"] != cfg["surface_model.type"]:
            raise ValueError(
                f"layout {layout_fname} is for "
                f"{marker_meta['surface_model_type']}, the model is "
                f"{cfg['surface_model.type']}")

        model = self._load_model()
        prior = self._load_pose_prior(model.model_type)

        betas_init = None
        if cfg.get("moshpp.betas_fname"):
            betas_init = np.load(cfg["moshpp.betas_fname"])["betas"]

        # optional head-marker correlation coupling (chmosh.py:252-266)
        head_corr = None
        hc_fname = cfg.get("moshpp.head_marker_corr_fname")
        if hc_fname and os.path.exists(hc_fname):
            head_meta = np.load(hc_fname)
            head_labels = [str(l) for l in head_meta["mrk_labels"]]
            if all(l in arrays["labels"] for l in head_labels):
                head_ids = [arrays["labels"].index(l) for l in head_labels]
                head_corr = (np.asarray(head_meta["corr"]), np.asarray(head_ids))
                self.logger.info("using head marker correlation (%d markers)",
                                 len(head_ids))

        obs, mask = frames_to_arrays(stagei_frames, arrays["labels"])
        opts = StageIOptions(
            optimize_fingers=cfg["moshpp.optimize_fingers"],
            optimize_face=cfg["moshpp.optimize_face"],
            optimize_toes=cfg["moshpp.optimize_toes"],
            optimize_betas=cfg["moshpp.optimize_betas"],
            num_betas=cfg["surface_model.num_betas"],
            num_expressions=cfg.get("surface_model.num_expressions", 10),
            expr_start=cfg.get("surface_model.betas_expr_start_id", 300),
            maxiter=cfg["opt_settings.maxiter"],
            e_3=float(cfg["opt_settings.stagei_lr"]),
            weights=_stagei_weights(cfg),
        )
        result = solve(
            model, obs, mask, arrays["labels"], arrays["vids"], arrays["m2b"],
            arrays["type_masks"], opts=opts, prior=prior, betas_init=betas_init,
            head_corr=head_corr, device=self.device)

        stagei_data = {
            "betas": _np(result.betas),
            "markers_latent": _np(result.markers_latent),
            "latent_labels": list(result.latent_labels),
            "marker_meta": dict(marker_meta),
            "markers_latent_vids": {k: int(v) for k, v in
                                    result.markers_latent_vids.items()},
            "stagei_debug_details": {
                "opt_models_trans": list(_np(result.trans)),
                "opt_models_pose": list(_np(result.poses)),
                "stagei_errs": {k: float(v) for k, v in result.errs.items()},
                "stagei_markers_sim": list(_np(result.markers_sim)),
                "stagei_markers_obs": list(obs),
                "stagei_labels_obs": [
                    [l for l, m in zip(result.latent_labels, fm) if m]
                    for fm in mask],
                "stagei_fnames": list(stagei_fnames),
                "stagei_frames": list(stagei_frames),
                "cfg": cfg.to_dict(),
                "stagei_elapsed_time": time.time() - tm,
            },
        }
        if cfg.get("moshpp.v_template_fname"):
            stagei_data["v_template_fname"] = cfg["moshpp.v_template_fname"]

        with open(_makepath(self.stagei_fname), "wb") as f:
            pickle.dump(stagei_data, f)
        self.stagei_data = stagei_data
        self.logger.info("created stagei_fname: %s (%.1fs)", self.stagei_fname,
                         stagei_data["stagei_debug_details"]["stagei_elapsed_time"])

        if cfg.get("dirs.write_optimized_marker_layout", True):
            MoSh.dump_stagei_marker_layout(self.stagei_fname,
                                           device=self.device)
        return self.stagei_fname

    # ------------------------------------------------------------ stage II
    def stageii_inputs(self) -> dict:
        """What the head's stage-ii solve takes, from the config and the
        stage-i result: the mocap session (`mocap`), the solved frames'
        indices (`frame_ids`), their observations (`obs` (F, M, 3) in
        meters, `mask` (F, M)) on the stage-i latent labels, the frozen
        problem (`prob`), the options (`opts`), the body prior (`prior`) and
        the model family (`model_type`)."""
        cfg = self.cfg
        if self.stagei_data is None:
            raise ValueError(f"run stage-i first ({self.stagei_fname} missing)")
        mocap = MocapSession(cfg["mocap.fname"], **self._mocap_filters())
        model = self._load_model()
        prior = self._load_pose_prior(model.model_type)
        latent_labels = list(self.stagei_data["latent_labels"])

        end = cfg["mocap.end_fidx"]
        frame_ids = np.arange(len(mocap))[
            cfg["mocap.start_fidx"]: (None if end == -1 else end): cfg["mocap.ds_rate"]]
        obs_all, mask_all = mocap.markers_for_labels(latent_labels)
        obs, mask = obs_all[frame_ids], mask_all[frame_ids]

        opts = StageIIOptions(
            optimize_fingers=cfg["moshpp.optimize_fingers"],
            optimize_face=cfg["moshpp.optimize_face"],
            optimize_toes=cfg["moshpp.optimize_toes"],
            optimize_dynamics=cfg["moshpp.optimize_dynamics"],
            num_betas=cfg["surface_model.num_betas"],
            num_dmpls=cfg.get("surface_model.num_dmpls", 8),
            num_expressions=cfg.get("surface_model.num_expressions", 10),
            expr_start=cfg.get("surface_model.betas_expr_start_id", 300),
            maxiter=cfg["opt_settings.maxiter"],
            smoothing_sweeps=cfg.get("opt_settings.smoothing_sweeps", 2),
            chunk_frames=cfg.get("opt_settings.chunk_frames", 16384),
            chunk_halo=cfg.get("opt_settings.chunk_halo", 32),
            weights=_stageii_weights(cfg),
        )
        # mid-stage crash recovery: long chunked runs checkpoint each solved
        # chunk beside the output pkl; a rerun after a crash resumes at the
        # first unsolved chunk (the reference restarts the whole sequential
        # loop, mosh_head.py:272). Removed once the stage pkl is written.
        if (cfg.get("opt_settings.chunk_checkpoint", True)
                and opts.chunk_frames and len(obs) > opts.chunk_frames):
            opts = dataclasses.replace(
                opts, checkpoint_dir=self.stageii_fname + ".ckpt")
        betas = self.stagei_data["betas"]
        if betas is None:
            betas = np.zeros(cfg["surface_model.num_betas"], np.float32)
        prob = prepare_stageii_problem(
            model, betas, self.stagei_data["markers_latent"], opts=opts,
            device=self.device)
        return dict(mocap=mocap, frame_ids=frame_ids, obs=obs, mask=mask,
                    prob=prob, opts=opts, prior=prior,
                    model_type=model.model_type)

    def mosh_stageii(self, mosh_stageii_func=None) -> str:
        """Run (or load cached) stage-ii. `mosh_stageii_func` optionally
        replaces the solver callable (`mosh_stageii_solve` signature,
        `device=` included) — the reference's injection pattern
        (mosh_head.py:268)."""
        solve = mosh_stageii_func or mosh_stageii_solve
        cfg = self.cfg
        if self.stagei_data is None:
            raise ValueError(f"run stage-i first ({self.stagei_fname} missing)")
        if os.path.exists(self.stageii_fname):
            with open(self.stageii_fname, "rb") as f:
                self.stageii_data = pickle.load(f)
            self.logger.info("loaded cached stage-ii: %s", self.stageii_fname)
            return self.stageii_fname

        tm = time.time()
        inp = self.stageii_inputs()
        mocap, frame_ids, obs, mask = (inp["mocap"], inp["frame_ids"],
                                       inp["obs"], inp["mask"])
        args = (inp["prob"], inp["opts"], obs, mask)
        kw = dict(prior=inp["prior"], model_type=inp["model_type"],
                  device=self.device)
        # per-phase per-objective telemetry, reference-style
        # (chmosh.py:408-417, 662-707)
        if mosh_stageii_func is None and cfg["moshpp.verbosity"] >= 1:
            result, report = solve(*args, return_report=True, **kw)
            self.logger.info("stage-ii per-phase energies:\n%s",
                             report.format_table())
        else:
            result = solve(*args, **kw)

        latent_labels = list(self.stagei_data["latent_labels"])
        labels_obs = [[l for l, m in zip(latent_labels, fm) if m] for fm in mask]
        stageii_data = {
            "trans": _np(result.trans),
            "fullpose": _np(result.fullpose),
            "stageii_debug_details": {
                "stageii_errs": {"data_mean_m": _np(result.data_err)},
                "markers_sim": _np(result.markers_sim),
                "markers_obs": obs,
                "labels_obs": labels_obs,
                "markers_orig": mocap.markers[frame_ids],
                "labels_orig": mocap.labels,
                "mocap_fname": cfg["mocap.fname"],
                "mocap_frame_rate": mocap.frame_rate,
                "mocap_time_length": mocap.time_length(),
                "stageii_elapsed_time": None,  # filled below
                "cfg": cfg.to_dict(),
            },
        }
        if cfg["moshpp.optimize_dynamics"]:
            stageii_data["dmpls"] = _np(result.extra)
        if cfg["moshpp.optimize_face"]:
            stageii_data["expression"] = _np(result.extra)

        stageii_data.update(self.stagei_data)
        stageii_data["stageii_debug_details"]["stageii_elapsed_time"] = time.time() - tm

        with open(_makepath(self.stageii_fname), "wb") as f:
            pickle.dump(stageii_data, f)
        if inp["opts"].checkpoint_dir:
            shutil.rmtree(inp["opts"].checkpoint_dir, ignore_errors=True)
        self.stageii_data = stageii_data
        self.logger.info("created stageii_fname: %s (%.1fs)", self.stageii_fname,
                         stageii_data["stageii_debug_details"]["stageii_elapsed_time"])
        return self.stageii_fname

    # -------------------------------------------------------------- exports
    @staticmethod
    def extract_marker_layout_from_mosh(mosh_stagei_pkl_fname,
                                        template_marker_layout_fname=None) -> dict:
        """Layout with stage-i-optimized vids substituted
        (mosh_head.py:561-581)."""
        if isinstance(mosh_stagei_pkl_fname, dict):
            mosh_stagei = mosh_stagei_pkl_fname
        else:
            with open(mosh_stagei_pkl_fname, "rb") as f:
                mosh_stagei = pickle.load(f)
        opt_vids = mosh_stagei["markers_latent_vids"]
        if template_marker_layout_fname:
            meta = marker_layout_load(template_marker_layout_fname)
        else:
            meta = copy.deepcopy(mosh_stagei["marker_meta"])
        for l in meta["marker_vids"]:
            if l in opt_vids:
                meta["marker_vids"][l] = opt_vids[l]
        return meta

    @staticmethod
    def dump_stagei_marker_layout(mosh_stagei_pkl_fname,
                                  out_marker_layout_fname=None,
                                  template_marker_layout_fname=None, *,
                                  device="cuda") -> None:
        """Write the optimized layout JSON (+ PLY/C3D inspection artifacts,
        mosh_head.py:303-340; the body for them is posed on `device`)."""
        meta = MoSh.extract_marker_layout_from_mosh(
            mosh_stagei_pkl_fname, template_marker_layout_fname)
        if out_marker_layout_fname is None:
            out_marker_layout_fname = str(mosh_stagei_pkl_fname).replace(".pkl", ".json")
        marker_layout_write(meta, out_marker_layout_fname)
        logger = get_logger()
        logger.info("created %s", out_marker_layout_fname)
        try:
            from moshpp_torch.tools.visualization import (
                marker_layout_as_mesh, marker_layout_to_c3d)
            with open(mosh_stagei_pkl_fname, "rb") as f:
                stagei = pickle.load(f)
            cfg = stagei["stagei_debug_details"]["cfg"]
            sm_fname = cfg["surface_model"]["fname"]
            body_parms = {}
            if stagei.get("betas") is not None:
                body_parms["betas"] = np.asarray(stagei["betas"])[
                    : cfg["surface_model"]["num_betas"]]
            marker_layout_as_mesh(
                sm_fname, body_parms=body_parms,
                surface_model_type=cfg["surface_model"]["type"],
                device=device)(
                out_marker_layout_fname,
                str(mosh_stagei_pkl_fname).replace(".pkl", ".ply"))
            marker_layout_to_c3d(
                out_marker_layout_fname, surface_model_fname=sm_fname,
                surface_model_type=cfg["surface_model"]["type"],
                out_c3d_fname=str(mosh_stagei_pkl_fname).replace(".pkl", ".c3d"),
                device=device)
        except Exception as e:  # inspection artifacts are best-effort
            logger.warning("layout mesh/c3d export skipped: %s", e)

    load_as_amass_npz = staticmethod(load_as_amass_npz)
    load_as_amass_npz_legacy = staticmethod(load_as_amass_npz_legacy)


def run_moshpp_once(cfg, *, device="cuda") -> MoSh:
    """End-to-end single-sequence run on `device` (mosh_head.py:584-606)."""
    mp = (MoSh(device=device, **cfg) if isinstance(cfg, dict)
          else MoSh(dict_cfg=cfg.to_dict(), device=device))
    mp.mosh_stagei()
    logger = get_logger()
    logger.info("stage-i errs: %s", mp.stagei_data["stagei_debug_details"]["stagei_errs"])
    if not mp.cfg.get("runtime.stagei_only", False):
        mp.mosh_stageii()
        errs = mp.stageii_data["stageii_debug_details"]["stageii_errs"]
        logger.info("stage-ii mean data err: %.4f mm",
                    1000.0 * float(np.mean(errs["data_mean_m"])))
    return mp
