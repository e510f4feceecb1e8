"""The synthetic world of tests/test_head.py (320-vertex SMPL+H, a 3-component
GMM prior, 14 markers, two 18-frame C3Ds in one session, a layout with the
true vertices), built with the port's functions alone, and the head's
config overrides on it: shared by the port's head, CLI and card tests."""

import json
import os

import numpy as np
import torch

from moshpp_torch.io.mocap import write_mocap_c3d
from moshpp_torch.markers.layout import marker_layout_write
from moshpp_torch.models.body_model import lbs_forward
from moshpp_torch.models.synthetic import make_synthetic_model, save_synthetic_npz
from moshpp_torch.ops.marker_transform import (marker_coeffs,
                                               reconstruct_markers,
                                               select_frame_indices)
from moshpp_torch.ops.surface import vertex_normals
from moshpp_torch.priors.gmm import save_gmm_prior_pkl

NUM_VERTS, MARKERS, FRAMES, SEQS = 320, 14, 18, 2

# Python run before a script that must work on the card's machine, which
# has neither JAX nor PyYAML: a meta-path finder that refuses them, and the
# JAX package, ahead of every other finder
BLOCK_JAX_AND_YAML = """
import importlib.abc, sys
class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "moshpp_tpu", "yaml"):
            raise ImportError(f"{name} is blocked")
sys.meta_path.insert(0, _Refuse())
"""


def build_world(root) -> dict:
    """tests/test_head.py's `synth_world` under `root` (the same numpy
    draws, the markers simulated by the port's forward model)."""
    root = str(root)
    rng = np.random.default_rng(7)
    model = make_synthetic_model("smplh", num_verts=NUM_VERTS, seed=21,
                                 dof_per_hand=6, device="cpu")
    support = os.path.join(root, "support", "smplh")
    os.makedirs(support, exist_ok=True)
    model_fname = os.path.join(support, "model.npz")
    save_synthetic_npz(model, model_fname)

    means = rng.normal(size=(3, 63)) * 0.05
    covs = np.stack([0.09 * np.eye(63) for _ in range(3)])
    save_gmm_prior_pkl({"means": means, "covars": covs,
                        "weights": np.ones(3) / 3},
                       os.path.join(support, "pose_body_prior.pkl"))

    vids = rng.choice(NUM_VERTS, MARKERS, replace=False)
    betas = torch.as_tensor(rng.normal(size=16).astype(np.float32) * 0.3)
    can_v = model.v_template + torch.einsum("vcb,b->vc",
                                            model.shapedirs[..., :16], betas)
    vn = vertex_normals(can_v, model.faces)
    latents = can_v[vids] + vn[vids] * 0.0095
    idx = select_frame_indices(can_v, latents)
    coeffs = marker_coeffs(can_v, latents, idx)
    labels = [f"MK{i:02d}" for i in range(MARKERS)]

    sess = os.path.join(root, "work_mocap", "SynthDS", "Subject0")
    os.makedirs(sess, exist_ok=True)
    with open(os.path.join(sess, "settings.json"), "w") as f:
        json.dump({"gender": "neutral"}, f)

    seq_fnames = []
    for s in range(SEQS):
        poses = np.zeros((FRAMES, model.pose_dof), np.float32)
        poses[0] = rng.normal(size=model.pose_dof) * 0.12
        for t in range(1, FRAMES):
            poses[t] = 0.95 * poses[t - 1] + rng.normal(
                size=model.pose_dof).astype(np.float32) * 0.03
        trans = np.cumsum(rng.normal(size=(FRAMES, 3)) * 0.008,
                          0).astype(np.float32)
        verts = lbs_forward(model, torch.as_tensor(poses), betas,
                            torch.as_tensor(trans))
        obs = reconstruct_markers(verts, idx, coeffs).numpy()
        fname = os.path.join(sess, f"seq{s}.c3d")
        write_mocap_c3d(obs, labels, fname, frame_rate=60)
        seq_fnames.append(fname)

    layout_fname = os.path.join(root, "SynthDS_smplh.json")
    marker_layout_write({
        "marker_vids": dict(zip(labels, [int(v) for v in vids])),
        "marker_type_mask": {"body": np.ones(MARKERS, bool)},
        "m2b_distance": {"body": 0.0095},
        "surface_model_type": "smplh",
    }, layout_fname)
    return dict(root=root, model_fname=model_fname, labels=labels,
                seq_fnames=seq_fnames, layout_fname=layout_fname,
                support=os.path.join(root, "support"))


def base_overrides(w: dict, work: str) -> dict:
    """tests/test_head.py's `_base_overrides`, the outputs under `work`."""
    return {
        "mocap.fname": w["seq_fnames"][0],
        "dirs.work_base_dir": str(work),
        "dirs.support_base_dir": w["support"],
        "dirs.marker_layout.fname": w["layout_fname"],
        "surface_model.type": "smplh",
        "surface_model.fname": w["model_fname"],
        "surface_model.num_betas": 16,
        "surface_model.dof_per_hand": 6,
        "moshpp.pose_hand_prior_fname": None,
        "moshpp.stagei_frame_picker.num_frames": 3,
        "moshpp.stagei_frame_picker.least_avail_markers": 0.5,
        "opt_settings.maxiter": 25,
        "opt_settings.smoothing_sweeps": 1,
        "mocap.end_fidx": 8,
    }
