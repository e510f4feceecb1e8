"""Operations and bytes that the simulated markers without their Jacobian
need (`marker_rows<sim[,ext|,tiled]>`, the trial point's cost): for every
frame, each marker's position from its three frame vertices, skinned by
the frame's joint transforms.

The count is of what these inputs need, whatever kernel computes it, at
the float32 rate (an FMA is 2), with the terms of `counts/marker_rows.py`.
Per frame vertex, with n its nonzero skinning weights:

- the pose blend v = v_shaped + posedirs . feat: 3 featN MACs;
- the skinning T = sum_j w_j [G_j | t_j] (12 n MACs) and T v + t (24);
- inline extras (route "ext"): each extra's shift of v (6);
- the tiled route: the wrapper's summed shift added to v (3).

Per marker: its frame and position (60).

Bytes: each frame's joint transforms (12 J), pose features, translation,
and extras (E, "ext") or summed vertex shifts (9 M, tiled) read once, the
markers written once; the tables (each frame vertex's shaped position,
posedirs rows and skinning weights, the marker coefficients and, inline,
the extra directions of the frame vertices) read once a launch.
"""

from __future__ import annotations


def _vertex_flops(st: dict, n: int) -> float:
    f = 6 * st["featN"] + 24 * n + 24
    if st["route"] == "ext":
        f += 6 * st["E"]
    elif st["route"] == "tiled":
        f += 3
    return f


def frame_flops(st: dict) -> float:
    """Operations of one frame."""
    return (sum(_vertex_flops(st, n) for n in st["weights_per_vertex"])
            + 60 * st["M"])


def frame_bytes(st: dict) -> float:
    """Bytes of one frame: inputs read once, outputs written once."""
    M, J, E, route = st["M"], st["J"], st["E"], st["route"]
    read = 12 * J + st["featN"] + 3
    if route == "ext":
        read += E
    elif route == "tiled":
        read += 9 * M
    return 4.0 * (read + 3 * M)


def table_bytes(st: dict) -> float:
    """Bytes of the marker tables, read once a launch."""
    per_vertex = 3 + 3 * st["featN"] + st["J"] + 1
    if st["route"] == "ext":
        per_vertex += 3 * st["E"]
    return 4.0 * 3 * st["M"] * per_vertex


def launch(st: dict, frames: int):
    """(operations, bytes) of one launch over `frames` frames."""
    return frames * frame_flops(st), frames * frame_bytes(st) + table_bytes(st)
