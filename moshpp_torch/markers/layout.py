"""Marker-layout files: load / write / filter / merge / family-remap (port
of `moshpp_tpu/markers/layout.py`, numpy).

A marker layout is a JSON file of markersets — each a marker type ('body',
'face', 'finger_left', …) with label->vertex-id indices and a
distance-from-skin — tied to one surface model family. Loading produces a
`MarkerLayout` with type-ordered labels, per-type boolean masks and skin
distances (reference semantics: `marker_layout/edit_tools.py:83-285`).
"""

from __future__ import annotations

import copy
import json
import os
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional, TypedDict, Union

import numpy as np

from moshpp_torch.markers.vids import smplh2smplx_vids, smplx2smplh_vids

DEFAULT_SKIN_DISTANCE = 0.0095  # meters, default marker-to-body offset


class MarkerLayout(TypedDict, total=False):
    marker_vids: "OrderedDict[str, int]"
    marker_type: "OrderedDict[str, str]"
    marker_type_mask: "OrderedDict[str, np.ndarray]"
    m2b_distance: "OrderedDict[str, float]"
    surface_model_type: str
    marker_colors: "OrderedDict[str, list]"
    marker_layout_fname: str


def _color_ramp(n: int) -> List[list]:
    """Red->blue ramp over n entries (stands in for the reference's
    colour-library ramp, edit_tools.py:163-166)."""
    if n <= 1:
        return [[1.0, 0.0, 0.0]] * max(n, 0)
    out = []
    for i in range(n):
        t = i / (n - 1)
        # hue sweep red (0) -> blue (2/3) in HSV, s=v=1
        h = (2.0 / 3.0) * t * 6.0
        k = int(h) % 6
        f = h - int(h)
        rgb = [(1, f, 0), (1 - f, 1, 0), (0, 1, f),
               (0, 1 - f, 1), (f, 0, 1), (1, 0, 1 - f)][k]
        out.append([float(c) for c in rgb])
    return out


def marker_layout_load(marker_layout_fname: Union[str, Path],
                       labels_map: Optional[Dict[str, str]] = None,
                       include_nan: bool = True,
                       exclude_marker_types: Optional[List[str]] = None,
                       exclude_markers: Optional[List[str]] = None,
                       only_markers: Optional[List[str]] = None) -> MarkerLayout:
    """Load a layout JSON into a `MarkerLayout`.

    Ordering matches the reference (edit_tools.py:136-160): markersets sorted
    by type, labels sorted within each set, alias map applied before sorting.
    Pass `labels_map=general_labels_map` for the standard vendor aliases.
    """
    marker_layout_fname = str(marker_layout_fname)
    assert marker_layout_fname.endswith(".json")
    with open(marker_layout_fname) as f:
        d = json.load(f)

    exclude_marker_types = exclude_marker_types or []
    exclude_markers = exclude_markers or []

    surface_model_type = d.get("surface_model_type", "smplx")

    marker_vids: "OrderedDict[str, int]" = OrderedDict()
    marker_types: "OrderedDict[str, List[str]]" = OrderedDict()
    m2b_distance: "OrderedDict[str, float]" = OrderedDict()

    for markerset in sorted(d["markersets"], key=lambda a: a["type"]):
        mtype = markerset["type"]
        if mtype in exclude_marker_types:
            continue
        if mtype in m2b_distance:
            raise ValueError(f"marker type appears twice in layout: {mtype}")
        m2b_distance[mtype] = markerset.get("distance_from_skin", DEFAULT_SKIN_DISTANCE)
        indices = markerset["indices"]
        if labels_map:
            indices = {labels_map.get(k, k): v for k, v in indices.items()}
        marker_types[mtype] = []
        for label in sorted(indices):
            if only_markers and label not in only_markers:
                continue
            if label in exclude_markers:
                continue
            if label in marker_vids:
                raise ValueError(f"label present in multiple markersets: {label}")
            marker_vids[label] = indices[label]
            marker_types[mtype].append(label)

    labels = list(marker_vids.keys())
    marker_type_mask = OrderedDict(
        (t, np.array([l in ls for l in labels])) for t, ls in marker_types.items())
    marker_type = OrderedDict()
    for l in labels:
        for t, ls in marker_types.items():
            if l in ls:
                marker_type[l] = t
                break

    colors = OrderedDict(zip(labels, _color_ramp(len(labels))))
    if include_nan:
        colors["nan"] = [0.83, 1, 0]

    return MarkerLayout(
        marker_vids=marker_vids,
        marker_colors=colors,
        marker_type=marker_type,
        marker_type_mask=marker_type_mask,
        m2b_distance=m2b_distance,
        surface_model_type=surface_model_type,
        marker_layout_fname=marker_layout_fname,
    )


def marker_layout_write(marker_meta: MarkerLayout,
                        marker_layout_fname: Union[str, Path]) -> None:
    marker_layout_fname = str(marker_layout_fname)
    assert marker_layout_fname.endswith(".json")
    os.makedirs(os.path.dirname(os.path.abspath(marker_layout_fname)), exist_ok=True)

    labels = np.array(list(marker_meta["marker_vids"].keys()))
    layout = {"surface_model_type": marker_meta["surface_model_type"], "markersets": []}
    for mtype, mask in marker_meta["marker_type_mask"].items():
        def as_native(v):
            return [int(x) for x in v] if isinstance(v, (list, np.ndarray)) else int(v)
        layout["markersets"].append({
            "indices": {l: as_native(marker_meta["marker_vids"][l])
                        for l in labels[np.asarray(mask, bool)]},
            "distance_from_skin": float(marker_meta["m2b_distance"][mtype]),
            "type": mtype,
        })
    with open(marker_layout_fname, "w") as f:
        json.dump(layout, f, sort_keys=True, indent=2, separators=(",", ": "))


def marker_meta_filter(marker_meta: MarkerLayout,
                       interested_labels: List[str]) -> MarkerLayout:
    """Restrict a layout to a label subset, preserving order and masks
    (edit_tools.py:186-200)."""
    new_meta = copy.deepcopy(marker_meta)
    keep = [l in interested_labels for l in marker_meta["marker_vids"]]
    for t, mask in new_meta["marker_type_mask"].items():
        new_meta["marker_type_mask"][t] = np.asarray(mask)[keep]
    new_meta["marker_vids"] = OrderedDict(
        (k, v) for k, v in marker_meta["marker_vids"].items() if k in interested_labels)
    new_meta["marker_colors"] = OrderedDict(
        (k, v) for k, v in marker_meta.get("marker_colors", {}).items()
        if k in list(interested_labels) + ["nan"])
    new_meta["marker_type"] = OrderedDict(
        (k, v) for k, v in marker_meta.get("marker_type", {}).items()
        if k in interested_labels)
    return new_meta


def merge_marker_layouts(marker_layout_fnames: List[Union[str, Path]],
                         out_fname: Optional[Union[str, Path]] = None,
                         labels_map: Optional[Dict[str, str]] = None) -> MarkerLayout:
    """Union several layouts into a superset whose vids are lists of all
    placements seen per label (edit_tools.py:223-285) — used by SOMA to
    synthesize layout variations."""
    assert marker_layout_fnames
    if out_fname is not None and os.path.exists(str(out_fname)):
        return marker_layout_load(str(out_fname), labels_map=labels_map)

    vids_by_type: Dict[str, Dict[str, list]] = {}
    m2b: Dict[str, float] = {}
    model_types = set()
    for fname in marker_layout_fnames:
        meta = marker_layout_load(str(fname), labels_map=labels_map)
        model_types.add(meta["surface_model_type"])
        labels = list(meta["marker_vids"].keys())
        for mtype, mask in meta["marker_type_mask"].items():
            bucket = vids_by_type.setdefault(mtype, {})
            for l, in_type in zip(labels, np.asarray(mask, bool)):
                if not in_type:
                    continue
                v = meta["marker_vids"][l]
                bucket.setdefault(l, []).extend(v if isinstance(v, list) else [v])
            if mtype in m2b:
                assert m2b[mtype] == meta["m2b_distance"][mtype], \
                    f"conflicting distance_from_skin for type {mtype}"
            m2b[mtype] = meta["m2b_distance"][mtype]
    assert len(model_types) == 1, \
        f"cannot merge layouts of different model families: {model_types}"

    marker_vids = OrderedDict()
    for mtype in sorted(vids_by_type):
        for l in sorted(vids_by_type[mtype]):
            marker_vids[l] = sorted(set(vids_by_type[mtype][l]))
    labels = list(marker_vids.keys())
    marker_type_mask = OrderedDict(
        (t, np.array([l in vids_by_type[t] for l in labels]))
        for t in sorted(vids_by_type))
    marker_type = OrderedDict(
        (l, next(t for t in sorted(vids_by_type) if l in vids_by_type[t]))
        for l in labels)

    meta = MarkerLayout(
        marker_vids=marker_vids,
        marker_type=marker_type,
        marker_type_mask=marker_type_mask,
        m2b_distance=OrderedDict((t, m2b[t]) for t in sorted(vids_by_type)),
        surface_model_type=list(model_types)[0],
        marker_colors=OrderedDict(zip(labels, _color_ramp(len(labels)))),
    )
    if out_fname is not None:
        marker_layout_write(meta, str(out_fname))
    return meta


def marker_meta_smplh2smplx(meta: MarkerLayout) -> MarkerLayout:
    """Remap a SMPL+H layout's vids onto the SMPL-X mesh
    (markerset_smplh2smplx.py:50-78)."""
    assert meta["surface_model_type"] in ("smpl", "smplh")
    new = copy.deepcopy(meta)
    new["surface_model_type"] = "smplx"
    new["marker_vids"] = OrderedDict(
        (l, smplh2smplx_vids(v) if (not isinstance(v, list) and v < 6890)
         else ([smplh2smplx_vids(x) for x in v] if isinstance(v, list) else v))
        for l, v in meta["marker_vids"].items())
    return new


def marker_meta_smplx2smplh(meta: MarkerLayout) -> MarkerLayout:
    """Inverse remap (markerset_smplh2smplx.py:81-96)."""
    assert meta["surface_model_type"] == "smplx"
    new = copy.deepcopy(meta)
    new["surface_model_type"] = "smplh"
    new["marker_vids"] = OrderedDict(
        (l, [smplx2smplh_vids(x) for x in v] if isinstance(v, list)
         else smplx2smplh_vids(v))
        for l, v in meta["marker_vids"].items())
    return new


def layout_arrays(meta: MarkerLayout) -> dict:
    """Dense arrays for the solver: labels, vids (M,) (the first vertex of
    a multi-vertex marker), m2b distances (M,) by marker type, and the
    per-type boolean masks."""
    labels = list(meta["marker_vids"].keys())
    vids = np.array([v[0] if isinstance(v, list) else v
                     for v in meta["marker_vids"].values()], np.int32)
    m2b = np.full(len(labels), DEFAULT_SKIN_DISTANCE, np.float32)
    for mtype, mask in meta["marker_type_mask"].items():
        m2b[np.asarray(mask, bool)] = meta["m2b_distance"][mtype]
    return {"labels": labels, "vids": vids, "m2b": m2b,
            "type_masks": {t: np.asarray(m, bool)
                           for t, m in meta["marker_type_mask"].items()}}
