"""Host-side rotation helpers for mocap preprocessing (port of
`moshpp_tpu/utils/rotations.py`, numpy)."""

from __future__ import annotations

import numpy as np


def rotate_points_xyz(points: np.ndarray, degrees_xyz) -> np.ndarray:
    """Rotate points by extrinsic X, then Y, then Z rotations (degrees).

    Matches the semantics of the human_body_prior helper the reference uses
    for `mocap.rotate` preprocessing (mocap_interface.py:227-228).
    points: (..., 3).
    """
    rx, ry, rz = [np.deg2rad(a) for a in np.asarray(degrees_xyz, np.float64).ravel()[:3]]

    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    R = Rz @ Ry @ Rx
    out = np.asarray(points) @ R.T
    return out.astype(np.asarray(points).dtype)
