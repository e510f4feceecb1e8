"""Operations and bytes that the per-frame joint quantities need
(`fk_smalls<jac|sim[,ext|,tiled]>`): for every frame, each joint's rotation
from its axis-angle, the forward kinematics down the tree, the skinning
translation and the pose-blend features and, with the Jacobian, the
rotation's derivative and the joint's path generators.

The count is of what these inputs need, whatever kernel computes it, at
the float32 rate (an FMA is 2; in the rotation a multiply, an add, sqrt,
sin, cos and a division are 1 each). Per joint of a frame:

- the rotation R from its axis-angle, in the quaternion form: 44 (the
  angle 7, its half-angle sine and cosine 4, the quaternion 3, its ten
  products 9 and R's entries 21);
- the chain, on each joint below the root: the parent's rotation by R (27
  MACs) and its translation by the offset (9), 72;
- the skinning translation A_tr = G_tr - G_rot j, 18; the features R - I
  of a joint below the root, 3;
- with the Jacobian: dR, 157 (the quaternion's derivative and each of R's
  entries by each axis-angle component); dR R^T, 162; the offset's
  column u = -dR R^T t, 54; W_rot = Q (dR R^T) Q^T, 324; W_tr = -W_rot b +
  Q u, 108: 805;
- inline extras (route "ext"): the rest offset and joint moved along the
  E directions, 12 E; with the Jacobian the chain of the extras' joint
  shifts S_e = S_e(parent) + Q d_e on each joint below the root (18 E)
  and datr_e = S_e - G_rot dj_e (18 E);
- the tiled route: the wrapper's summed shifts added to the offset and
  the joint, 6.

Bytes: each frame's axis-angles (3 J), extras (E, route "ext") or summed
shifts (6 J, tiled) read once; its outputs written once: G_rot, A_tr and
the features (9 J + 3 J + 9 (J - 1)), with the Jacobian W_rot, W_tr and dR
(27 J + 9 J + 27 J), and datr (3 E J, "ext") or Q (9 J, tiled); the
tables (the rest joints and offsets, each joint's ancestor mask as 8
bytes, the extra directions 6 E J) read once a launch.
"""

from __future__ import annotations

ROTATION = 44
CHAIN = 72
A_TR = 18
FEATURES = 3
JACOBIAN = 157 + 162 + 54 + 324 + 108


def frame_flops(st: dict, with_jac: bool) -> float:
    """Operations of one frame."""
    J, E, route = st["J"], st["E"], st["route"]
    below = J - 1                      # joints below the root
    f = J * (ROTATION + A_TR) + below * (CHAIN + FEATURES)
    if with_jac:
        f += J * JACOBIAN
    if route == "ext":
        f += J * 12 * E
        if with_jac:
            f += below * 18 * E + J * 18 * E
    elif route == "tiled":
        f += J * 6
    return f


def frame_bytes(st: dict, with_jac: bool) -> float:
    """Bytes of one frame: inputs read once, outputs written once."""
    J, E, route = st["J"], st["E"], st["route"]
    read = 3 * J + (E if route == "ext" else 0) + (6 * J if route == "tiled"
                                                   else 0)
    written = 9 * J + 3 * J + 9 * (J - 1)
    if with_jac:
        written += 27 * J + 9 * J + 27 * J
        if route == "ext":
            written += 3 * E * J
        elif route == "tiled":
            written += 9 * J
    return 4.0 * (read + written)


def table_bytes(st: dict) -> float:
    """Bytes of the tables, read once a launch: the rest joints and
    offsets, the ancestor masks and, inline, the extra directions."""
    J, E = st["J"], st["E"]
    ext = 6 * E * J if st["route"] == "ext" else 0
    return 4.0 * (6 * J + ext) + 8.0 * J


def launch(st: dict, frames: int, with_jac: bool):
    """(operations, bytes) of one launch over `frames` frames."""
    return (frames * frame_flops(st, with_jac),
            frames * frame_bytes(st, with_jac) + table_bytes(st))
