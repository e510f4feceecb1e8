"""Marker vertex tables the stage-ii solve needs (from
`moshpp_tpu/markers/vids.py`, copied so that this package needs no JAX)."""

from __future__ import annotations

import numpy as np

SMPLX_NUM_VERTS = 10475


def smplx_eyeball_vids() -> np.ndarray:
    """SMPL-X eyeball vertex ids, the last 1092 vertices [9383, 10475):
    excluded from the markers' nearest-neighbour frame vertices."""
    return np.arange(9383, SMPLX_NUM_VERTS)


def smplx_eyeball_mask(num_verts: int) -> np.ndarray:
    """(V,) bool mask of the vertices to exclude from the markers' frame
    vertices: the eyeballs on a 10475-vertex SMPL-X mesh, none otherwise."""
    mask = np.zeros(num_verts, dtype=bool)
    if num_verts == SMPLX_NUM_VERTS:
        mask[smplx_eyeball_vids()] = True
    return mask
