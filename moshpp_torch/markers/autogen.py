"""Auto-generate a marker layout from observed mocap labels (port of
`moshpp_tpu/markers/autogen.py`; reference:
`marker_layout/create_marker_layout_for_mocaps.py:44-132`).

Looks every (alias-normalized) label up in the per-family marker database and
assigns it a marker type — face / finger_left / finger_right / wrist-on-stick
/ body — with the standard per-type skin distances.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from moshpp_torch.markers.layout import MarkerLayout, marker_layout_write
from moshpp_torch.markers.vids import (all_marker_vids, general_labels_map,
                                       marker_type_labels)
from moshpp_torch.utils.logging import get_logger

MEAN_SKIN_DISTANCE = {
    "wrist": 0.039,
    "body": 0.0095,
    "face": 0.0002,
    "finger_right": 0.0002,
    "finger_left": 0.0002,
}


def marker_labels_to_marker_layout(chosen_markers: List[str],
                                   marker_layout_fname: str,
                                   surface_model_type: str,
                                   labels_map: Optional[Dict[str, str]] = None,
                                   wrist_markers_on_stick: bool = False,
                                   separate_types: Optional[List[str]] = None) -> MarkerLayout:
    """Build and write a layout JSON for the given observed labels.

    Returns the written layout (the reference returns a bool; having the meta
    back saves a re-read).
    """
    logger = get_logger()
    if separate_types is None:
        separate_types = ["body", "face", "finger"]
    if labels_map is None:
        labels_map = general_labels_map

    assert surface_model_type in all_marker_vids.keys(), (
        f"no marker database for surface_model_type: {surface_model_type}")

    has_face = surface_model_type in ("smplx", "flame") and "face" in separate_types
    has_finger = surface_model_type in ("smplh", "smplx", "mano") and "finger" in separate_types
    has_body = surface_model_type not in ("mano", "flame")

    db = all_marker_vids[surface_model_type]
    unique_labels = sorted(set(labels_map.get(l, l) for l in chosen_markers))

    marker_vids = OrderedDict()
    unknown = []
    for l in unique_labels:
        if l in db:
            marker_vids[l] = db[l]
        else:
            unknown.append(l)
    if unknown:
        logger.warning(
            "unknown marker label(s) for %s skipped: %s", surface_model_type, unknown)

    type_order = []
    if has_face:
        type_order.append("face")
    if has_finger:
        type_order += ["finger_left", "finger_right"]
    if wrist_markers_on_stick:
        type_order.append("wrist")
    if has_body:
        type_order.append("body")

    masks = {t: np.zeros(len(marker_vids), bool) for t in type_order}
    for i, l in enumerate(marker_vids):
        if has_face and l in marker_type_labels["face"]:
            masks["face"][i] = True
        elif has_finger and l in marker_type_labels["finger_left"]:
            masks["finger_left"][i] = True
        elif has_finger and l in marker_type_labels["finger_right"]:
            masks["finger_right"][i] = True
        elif wrist_markers_on_stick and l in marker_type_labels["wrist"]:
            masks["wrist"][i] = True
        elif has_body:
            masks["body"][i] = True
        else:
            raise ValueError(f"marker {l} could not be assigned a marker type")

    present = {t: m for t, m in masks.items() if m.sum()}
    meta = MarkerLayout(
        marker_vids=marker_vids,
        marker_type_mask=OrderedDict(present),
        m2b_distance=OrderedDict((t, MEAN_SKIN_DISTANCE[t]) for t in present),
        surface_model_type=surface_model_type,
    )
    marker_layout_write(meta, marker_layout_fname)
    logger.info("created marker layout: %s", marker_layout_fname)
    return meta
