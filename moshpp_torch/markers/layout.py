"""The solver's view of a marker layout (from `moshpp_tpu/markers/layout.py`,
copied so that this package needs no JAX).

A layout (the JAX package's `MarkerLayout` dict: `marker_vids`,
`marker_type_mask`, `m2b_distance`) becomes the dense arrays stage i takes.
Loading, writing, merging and the SMPL-H <-> SMPL-X remaps need the label
tables of `moshpp_tpu/markers/vids.py` and are not ported yet (ROADMAP
Queue 1 item 6).
"""

from __future__ import annotations

import numpy as np

DEFAULT_SKIN_DISTANCE = 0.0095  # meters, default marker-to-body offset


def layout_arrays(meta: dict) -> dict:
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
