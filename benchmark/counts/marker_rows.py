"""Operations and bytes that the marker rows with their Jacobian need
(`marker_rows<jac[,ext|,tiled]>`): for every frame, each marker's position
from its three frame vertices and its exact derivative by every column of
x, from the frame's joint transforms.

The count is of what these inputs need, whatever kernel computes it, at
the float32 rate (an FMA is 2). Per frame vertex, with n its nonzero
skinning weights and a the joints on their root paths:

- the pose blend v = v_shaped + posedirs . feat: 3 featN MACs;
- the skinning T = sum_j w_j [G_j | t_j] (12 n MACs) and T v + t (24);
- the skinning chain's columns: per ancestor, the weighted point of the
  joints below it (6 n) and three cross products with its axes (27);
- the pose blend's columns: per non-root joint, posedirs' 3 x 9 block by
  the feature derivative 9 x 3 (162) and three columns turned by T (54);
- inline extras (route "ext"): each extra's shift of v (6) and its column
  (18 + 6 n);
- the tiled route's vertex shift (3).

Per marker: its frame and position (60), the position's derivative by its
three vertices (270), the columns combined over the vertices (54 a
column, 3 J rotation columns, E more inline), the hand PCA (3 rows, each
hand's 45 axis-angle columns onto its PCA dofs), on the tiled route the
chain factors U, V (162).

Bytes: each frame's joint transforms (12 J), pose features, translation
and extras read once, the markers and the Jacobian's columns written once
(the tiled route writes its chain factors, 54 a marker, and leaves the
extras' columns to `extras_cols`), and the tables of the marker frames
read once a launch.
"""

from __future__ import annotations


def _vertex_flops(st: dict, n: int, a: int) -> float:
    featN, J, E = st["featN"], st["J"], st["E"]
    f = 6 * featN + 24 * n + 24 + a * (6 * n + 27) + (J - 1) * 216
    if st["route"] == "ext":
        f += E * (6 + 18 + 6 * n)
    elif st["route"] == "tiled":
        f += 3
    return f


def _marker_flops(st: dict) -> float:
    J, E = st["J"], st["E"]
    f = 60 + 270 + 54 * 3 * J
    if st["hands"]:
        per_hand = st["hand_pca"] // st["hands"]
        f += 2 * 3 * st["hand_aa"] * per_hand
    if st["route"] == "ext":
        f += 54 * E
    elif st["route"] == "tiled":
        f += 162
    return f


def frame_flops(st: dict) -> float:
    """Operations of one frame."""
    f = sum(_vertex_flops(st, n, a) for n, a in
            zip(st["weights_per_vertex"], st["ancestors_per_vertex"]))
    return f + st["M"] * _marker_flops(st)


def frame_bytes(st: dict) -> float:
    """Bytes of one frame: inputs read once, outputs written once."""
    M, J, D, E = st["M"], st["J"], st["D"], st["E"]
    cols = D - E if st["route"] == "tiled" else D
    read = 12 * J + st["featN"] + 3 + E
    written = 3 * M + 3 * M * cols + (54 * M if st["route"] == "tiled" else 0)
    return 4.0 * (read + written)


def table_bytes(st: dict) -> float:
    """Bytes of the marker tables, read once a launch: each frame vertex's
    shaped position, posedirs rows, skinning weights and their root-path
    sums, and the coefficients."""
    return 4.0 * 3 * st["M"] * (3 + 3 * st["featN"] + 2 * st["J"] + 1)


def launch(st: dict, frames: int):
    """(operations, bytes) of one launch over `frames` frames."""
    return frames * frame_flops(st), frames * frame_bytes(st) + table_bytes(st)
