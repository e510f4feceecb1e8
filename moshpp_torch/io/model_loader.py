"""Load SMPL-family model files into the port's `SurfaceModel` (port of
`moshpp_tpu/io/model_loader.py`: the same numpy arrays, then tensors on a
device).

Accepts the official .pkl distribution format (latin-1 pickles that may embed
chumpy arrays — tolerated without chumpy installed via a shim unpickler), the
.npz conversions, and this package's synthetic npz fixtures.

Mirrors the semantics of the reference loader
(the reference's `models/smpl_fast_derivatives.py:52-166`):
model-type inference from posedirs width, MANO/SMPL-H/SMPL-X hand-PCA
subspace splicing from a pose_hand_prior file, optional v_template override.
The chumpy/C++ machinery it wires up is replaced by the functional forward in
`models/body_model.py`.
"""

from __future__ import annotations

import io
import pickle
from pathlib import Path
from typing import Optional, Union

import numpy as np

from moshpp_torch.models.body_model import (MODEL_TYPE_INFO, SurfaceModel,
                                            surface_model_from_arrays)
from moshpp_torch.models.kintree import DEFAULT_PARENTS

_POSEDIRS_TO_TYPE = {69: "smpl", 153: "smplh", 162: "smplx", 45: "mano",
                     105: "animal_horse", 102: "animal_dog"}


class _ChumpyShim:
    """Stands in for chumpy.Ch during unpickling; keeps only the array data."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.__dict__.update(state if isinstance(state, dict) else {})

    @property
    def r(self):
        return self.__dict__.get("x")


class _TolerantUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChumpyShim
        if module.startswith("scipy.sparse"):
            # let scipy resolve its own classes
            import importlib
            return getattr(importlib.import_module(module), name)
        return super().find_class(module, name)


def _to_np(x):
    if x is None:
        return None
    if isinstance(x, _ChumpyShim):
        x = x.r
    if hasattr(x, "toarray"):  # scipy sparse
        return np.asarray(x.toarray())
    return np.asarray(x)


def _read_model_dict(fname: str) -> dict:
    if fname.endswith(".pkl"):
        with open(fname, "rb") as f:
            data = f.read()
        return _TolerantUnpickler(io.BytesIO(data), encoding="latin-1").load()
    if fname.endswith(".npz"):
        return dict(np.load(fname, allow_pickle=True))
    raise ValueError(f"unsupported surface model file: {fname}")


def _load_ply_verts(fname: str) -> np.ndarray:
    from moshpp_torch.io.ply import read_ply
    return read_ply(fname)[0]


def load_dmpl_eigvecs(dmpl_fname: str) -> np.ndarray:
    """DMPL soft-tissue eigvectors (V, 3, K) from pkl/npz
    (chmosh.py:511 `pickle['eigvec']`)."""
    if str(dmpl_fname).endswith(".npz"):
        return np.asarray(np.load(dmpl_fname)["eigvec"])
    with open(dmpl_fname, "rb") as f:
        return np.asarray(pickle.load(f, encoding="latin-1")["eigvec"])


def load_surface_model_arrays(surface_model_fname: Union[str, Path],
                              surface_model_type: Optional[str] = None,
                              pose_hand_prior_fname: Optional[str] = None,
                              use_hands_mean: bool = False,
                              dof_per_hand: int = 12,
                              num_betas: int = 16,
                              v_template_fname: Optional[str] = None,
                              dmpl_fname: Optional[str] = None,
                              num_dmpls: int = 8,
                              dtype=np.float32) -> dict:
    """Read a model file into the numpy arrays of a `SurfaceModel` (keyed
    by field name) and its static fields (`model_type`, `parents`,
    `num_betas`, `dof_per_hand`, `skin_k`).

    Args:
      pose_hand_prior_fname: npz with `componentsl/componentsr` (+
        `hands_meanl/r`) — required for smplh/smplx, matching the reference's
        requirement at `smpl_fast_derivatives.py:83`. MANO files carry their
        own `hands_components`.
      use_hands_mean: add the MANO mean hand pose to the PCA reconstruction.
      dof_per_hand: PCA coefficients kept per hand.
      dmpl_fname: optional DMPL eigvec file; its first `num_dmpls` components
        are spliced into shapedirs columns [num_betas, num_betas+num_dmpls)
        (the reference's stage-ii splice, chmosh.py:507-514) so soft-tissue
        coefficients ride the betas tail.
    """
    surface_model_fname = str(surface_model_fname)
    dd = _read_model_dict(surface_model_fname)

    def get(key, default=None):
        v = dd.get(key, default)
        if isinstance(v, np.ndarray) and v.dtype == object and v.shape == ():
            v = v.item()
        return v

    posedirs = _to_np(dd["posedirs"]).astype(dtype)
    njoint_parms = posedirs.shape[2] // 3
    model_type = surface_model_type or str(get("model_type") or
                                           _POSEDIRS_TO_TYPE[njoint_parms])
    info = MODEL_TYPE_INFO[model_type]

    v_template = _to_np(dd["v_template"]).astype(dtype)
    if v_template_fname is not None:
        v_template = _load_ply_verts(v_template_fname).astype(dtype)
    shapedirs = _to_np(dd["shapedirs"]).astype(dtype)
    weights = _to_np(dd["weights"]).astype(dtype)
    faces = _to_np(dd["f"]).astype(np.int32)

    kintree = get("kintree_table")
    if kintree is not None:
        kintree = _to_np(kintree)
        parents = tuple(int(p) if p < 2 ** 31 else -1 for p in kintree[0])
    else:
        parents = DEFAULT_PARENTS[model_type]
    assert len(parents) == info.num_joints, (
        f"{model_type}: expected {info.num_joints} joints, file has {len(parents)}")

    if dmpl_fname is not None:
        eig = load_dmpl_eigvecs(dmpl_fname).astype(dtype)[:, :, :num_dmpls]
        width = num_betas + num_dmpls
        if shapedirs.shape[-1] < width:
            shapedirs = np.concatenate(
                [shapedirs[..., :num_betas],
                 np.zeros((*shapedirs.shape[:2], width - num_betas), dtype)],
                axis=-1)
        shapedirs = shapedirs.copy()
        shapedirs[..., num_betas:width] = eig

    # joint regression folded into joint_template/joint_shapedirs so subsetted
    # models stay kinematically exact (body_model.py docstring)
    if "joint_template" in dd:  # synthetic fixture convention
        joint_template = _to_np(dd["joint_template"]).astype(dtype)
        joint_shapedirs = _to_np(dd["joint_shapedirs"]).astype(dtype)
        if dmpl_fname is not None and joint_shapedirs.shape[-1] < shapedirs.shape[-1]:
            pad = shapedirs.shape[-1] - joint_shapedirs.shape[-1]
            joint_shapedirs = np.concatenate(
                [joint_shapedirs,
                 np.zeros((*joint_shapedirs.shape[:2], pad), dtype)], axis=-1)
    else:
        jreg = _to_np(dd["J_regressor"]).astype(dtype)
        joint_template = jreg @ v_template
        joint_shapedirs = np.einsum("jv,vcb->jcb", jreg, shapedirs)

    # hand-PCA subspace
    hands_components = np.zeros((0, 0), dtype)
    hands_mean = np.zeros((0,), dtype)
    if info.has_hands:
        if model_type == "mano":
            comps = _to_np(dd["hands_components"]).astype(dtype)
            hands_components = comps[:dof_per_hand]
            # NOTE: reference zeroes the mean when use_hands_mean is True for
            # MANO (smpl_fast_derivatives.py:114) — that reads like a bug; we
            # follow the flag's documented meaning instead.
            mean = _to_np(dd["hands_mean"]).astype(dtype)
            hands_mean = mean if use_hands_mean else np.zeros_like(mean)
        elif "hands_components" in dd:  # synthetic fixture convention
            hands_components = _to_np(dd["hands_components"]).astype(dtype)
            hands_mean = _to_np(dd["hands_mean"]).astype(dtype)
            # stored components are already truncated; keep dof consistent
            dof_per_hand = hands_components.shape[0] // max(info.num_hands, 1)
        else:
            assert pose_hand_prior_fname is not None, (
                f"{model_type} requires pose_hand_prior_fname (componentsl/r npz)")
            hp = np.load(pose_hand_prior_fname)
            cl = np.asarray(hp["componentsl"], dtype)[:dof_per_hand]
            cr = np.asarray(hp["componentsr"], dtype)[:dof_per_hand]
            hands_components = np.block(
                [[cl, np.zeros_like(cl)], [np.zeros_like(cr), cr]])
            if use_hands_mean:
                hands_mean = np.concatenate(
                    [np.asarray(hp["hands_meanl"], dtype),
                     np.asarray(hp["hands_meanr"], dtype)])
            else:
                hands_mean = np.zeros(cl.shape[1] + cr.shape[1], dtype)

    # sparse-skinning bound: SMPL-family weights have <= 4 nonzeros/vertex
    nnz = int((weights > 1e-7).sum(axis=1).max())
    skin_k = nnz if nnz <= 8 else 0

    return dict(
        v_template=v_template,
        shapedirs=shapedirs,
        posedirs=posedirs,
        weights=weights,
        joint_template=joint_template,
        joint_shapedirs=joint_shapedirs,
        hands_components=hands_components,
        hands_mean=hands_mean,
        faces=faces,
        model_type=model_type,
        parents=parents,
        num_betas=num_betas,
        dof_per_hand=dof_per_hand,
        skin_k=skin_k,
    )


def load_surface_model(surface_model_fname: Union[str, Path],
                       surface_model_type: Optional[str] = None,
                       pose_hand_prior_fname: Optional[str] = None,
                       use_hands_mean: bool = False,
                       dof_per_hand: int = 12,
                       num_betas: int = 16,
                       v_template_fname: Optional[str] = None,
                       dmpl_fname: Optional[str] = None,
                       num_dmpls: int = 8,
                       *, device) -> SurfaceModel:
    """Load a model file into a `SurfaceModel` on `device`
    (`load_surface_model_arrays` says what is read)."""
    a = load_surface_model_arrays(
        surface_model_fname, surface_model_type, pose_hand_prior_fname,
        use_hands_mean, dof_per_hand, num_betas, v_template_fname,
        dmpl_fname, num_dmpls)
    return surface_model_from_arrays(
        a, a["model_type"], a["parents"], a["dof_per_hand"],
        num_betas=a["num_betas"], skin_k=a["skin_k"], device=device)
