"""Mocap session ingestion (port of `moshpp_tpu/io/mocap.py`; reference:
`tools/mocap_interface.py:51-303`).

Reads labeled marker trajectories from .c3d (in-house codec), .npz, .pkl and
.mat files into a `MocapSession`: (frames, markers, 3) float arrays in
meters, cleaned labels, per-subject masks, availability masks. Where the
reference materializes per-frame label->point dicts for the solver
(markers_asdict), the pipeline consumes the dense
`markers` + `availability_mask` arrays directly (static shapes);
`markers_asdict()` is provided for API parity.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np

from moshpp_torch.io.c3d import read_c3d, write_c3d
from moshpp_torch.utils.rotations import rotate_points_xyz


def write_mocap_c3d(markers: np.ndarray, labels: List[str],
                    out_mocap_fname: str, frame_rate: float = 120.0) -> None:
    """Write markers (frames, markers, 3) in meters to a mm C3D file.

    Zero or NaN points are marked invalid (reference convention,
    mocap_interface.py:67-83).
    """
    assert str(out_mocap_fname).endswith(".c3d")
    markers = np.asarray(markers, np.float64) * 1000.0  # m -> mm
    missing = np.logical_or(np.isnan(markers), markers == 0).sum(-1) == 3
    pts = markers.copy()
    pts[missing] = np.nan
    write_c3d(str(out_mocap_fname), pts, labels, frame_rate=frame_rate)


def read_mocap(mocap_fname: str) -> dict:
    """Raw read: markers (F, M, 3), labels, frame_rate, subject masks.

    Format semantics follow mocap_interface.py:87-162 — including the
    `Subject:Label` prefix convention for multi-subject captures and `*N`
    autolabels for unlabeled points.
    """
    mocap_fname = str(mocap_fname)
    labels = None
    frame_rate = None
    raw = None

    if mocap_fname.endswith(".mat"):
        import scipy.io
        md = scipy.io.loadmat(mocap_fname)
        markers = next((md[k] for k in ("MoCaps", "Markers") if k in md), None)
        if markers is None:
            raise ValueError(
                f"no marker field (MoCaps/Markers) in mat file: {mocap_fname}")
        if "Labels" in md:
            labels = np.vstack(md["Labels"][0]).ravel().tolist()
        raw = md
    elif mocap_fname.endswith(".pkl"):
        with open(mocap_fname, "rb") as f:
            md = pickle.load(f, encoding="latin-1")
        markers = md["markers"]
        frame_rate = (md.get("frame_rate")
                      or md.get("required_parameters", {}).get("frame_rate"))
        labels = md.get("labels")
        if isinstance(labels, np.ndarray):
            labels = labels.tolist()
        if labels:
            labels = [f"*{i}" if isinstance(l, np.ndarray) else l
                      for i, l in enumerate(labels)]
        raw = md
    elif mocap_fname.endswith(".c3d"):
        c3 = read_c3d(mocap_fname)
        markers = c3.points
        frame_rate = c3.frame_rate
        labels = list(c3.labels)
        raw = c3
    elif mocap_fname.endswith(".npz"):
        md = np.load(mocap_fname, allow_pickle=True)
        markers = md["markers"]
        if "frame_rate" in md:
            frame_rate = float(md["frame_rate"])
        labels = md["labels"].tolist() if "labels" in md else None
        raw = md
    else:
        raise ValueError(f"unrecognized mocap format: {mocap_fname}")

    markers = np.asarray(markers, np.float64)
    if labels is None:
        labels = [f"*{i}" for i in range(markers.shape[1])]
    elif len(labels) < markers.shape[1]:
        labels = list(labels) + [f"*{i}" for i in range(markers.shape[1] - len(labels))]
    labels = [l.decode() if isinstance(l, bytes) else str(l) for l in labels]

    subject_of = [l.split(":")[0] if ":" in l else "null" for l in labels]
    subject_names = list(dict.fromkeys(subject_of))
    subject_mask = {s: np.array([x == s for x in subject_of]) for s in subject_names}

    return {"markers": markers, "labels": labels, "frame_rate": frame_rate,
            "subject_mask": subject_mask, "_marker_data": raw}


class MocapSession:
    """One mocap sequence: markers in meters + labels + masks.

    Mirrors the reference's cleanup pipeline (mocap_interface.py:165-253):
    unit scaling, whitespace strip, subject-prefix removal, vendor label
    aliasing, star/exclude/only filters, NaN->0, optional rotation, subject
    selection.
    """

    def __init__(self, mocap_fname: Union[str, Path], mocap_unit: str = "mm",
                 mocap_rotate: Optional[list] = None,
                 exclude_markers: Optional[List[str]] = None,
                 only_subjects: Optional[List[str]] = None,
                 only_markers: Optional[List[str]] = None,
                 labels_map: Optional[Dict[str, str]] = None,
                 ignore_stared_labels: bool = True,
                 remove_label_before_colon: bool = True):
        scale = {"mm": 1000.0, "cm": 100.0, "m": 1.0}[mocap_unit]
        self.mocap_fname = str(mocap_fname)
        self.read_status = False
        if only_subjects is not None and not isinstance(only_subjects, list):
            raise ValueError("only_subjects must be a list of subject names")

        data = read_mocap(self.mocap_fname)
        self._marker_data = data["_marker_data"]

        labels = [l.replace(" ", "") for l in data["labels"]]
        if remove_label_before_colon:
            labels = [l.split(":")[-1] for l in labels]
        if labels_map:
            labels = [labels_map.get(l, l) for l in labels]

        keep = np.ones(len(labels), bool)
        if only_markers is not None:
            keep = np.array([l in only_markers for l in labels])
        else:
            if ignore_stared_labels:
                keep &= np.array([not l.startswith("*") for l in labels])
            if exclude_markers:
                keep &= np.array([l not in exclude_markers for l in labels])

        labels = [l for l, k in zip(labels, keep) if k]
        subject_mask = {k: v[keep] for k, v in data["subject_mask"].items()}
        markers = data["markers"][:, keep]

        missing = ~MocapSession.marker_availability_mask(markers)
        markers = markers.copy()
        markers[missing] = 0.0

        if mocap_rotate is not None:
            markers = rotate_points_xyz(markers, mocap_rotate)

        subject_names = sorted(subject_mask.keys())
        if only_subjects:
            unknown = [s for s in only_subjects if s not in subject_names]
            if unknown:
                raise ValueError(
                    f"subjects {unknown} not in mocap (have {subject_names})")
            sel = np.zeros(markers.shape[1], bool)
            for s in only_subjects:
                sel |= subject_mask[s]
            subject_mask = {k: v[sel] for k, v in subject_mask.items()
                            if k in only_subjects}
            subject_names = only_subjects
            markers = markers[:, sel]
            labels = [l for l, k in zip(labels, sel) if k]

        self.markers = markers / scale
        self.labels = labels
        self.subject_mask = subject_mask
        self.subject_names = subject_names
        self.multi_subject = len([s for s in subject_names if s != "null"]) > 1
        fr = data.get("frame_rate")
        self.frame_rate = 120.0 if fr is None else float(fr)
        self.read_status = True

    # -- dense accessors (the solver's path) ------------------------------
    def availability_mask(self) -> np.ndarray:
        """(F, M) bool — marker observed this frame."""
        return MocapSession.marker_availability_mask(self.markers)

    def markers_for_labels(self, wanted_labels: List[str]):
        """Fixed-size gather to a label list: (F, len(wanted), 3) + mask.

        Labels absent from the session come back all-missing. This is the
        static-shape replacement for the reference's per-frame label
        intersection (chmosh.py:591-594).
        """
        F = self.markers.shape[0]
        out = np.zeros((F, len(wanted_labels), 3))
        mask = np.zeros((F, len(wanted_labels)), bool)
        pos = {l: i for i, l in enumerate(self.labels)}
        avail = self.availability_mask()
        for j, l in enumerate(wanted_labels):
            i = pos.get(l)
            if i is not None:
                out[:, j] = self.markers[:, i]
                mask[:, j] = avail[:, i]
        out[~mask] = 0.0
        return out, mask

    # -- API-parity accessors ----------------------------------------------
    def markers_asdict(self) -> List[Dict[str, np.ndarray]]:
        """Per-frame {label: xyz} dicts (observed markers only)."""
        avail = self.availability_mask()
        out = []
        for t in range(self.markers.shape[0]):
            out.append({l: self.markers[t, i]
                        for i, l in enumerate(self.labels) if avail[t, i]})
        return out

    @staticmethod
    def marker_availability_mask(markers: np.ndarray) -> np.ndarray:
        return np.logical_and(np.isnan(markers).sum(-1) == 0,
                              (markers == 0).sum(-1) != 3)

    def __len__(self) -> int:
        return self.markers.shape[0]

    def __getitem__(self, given):
        return self.markers[given]

    def time_length(self) -> float:
        return self.markers.shape[0] / self.frame_rate

    def write_as_c3d(self, out_c3d_fname: Union[str, Path]) -> None:
        write_mocap_c3d(self.markers, self.labels, str(out_c3d_fname),
                        frame_rate=self.frame_rate)

    def write_as_npz(self, out_npz_fname: Union[str, Path]) -> None:
        assert str(out_npz_fname).endswith(".npz")
        np.savez(out_npz_fname, markers=self.markers, labels=self.labels,
                 frame_rate=self.frame_rate)
