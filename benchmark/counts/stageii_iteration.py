"""Operations of one dogleg iteration of one frame of the stage-ii solve,
the work a frame-iteration needs whatever implements it, at the float32
rate (an FMA is 2), counted from the shapes (M markers, J joints, D
columns of x, E extras, the prior's K components of width d):

- forward kinematics with the rotation derivatives: 276 a joint (the
  rotation and its derivative 150, the chain 72, the joint axes 54), and
  the hand PCA expanded to axis-angles;
- the marker rows and their Jacobian (`counts/marker_rows.py`), and with
  extras beyond the inline route their columns (the joint shifts, 18 a
  joint and extra, and each frame vertex's 24 + 6 n an extra, 54 an extra
  a marker);
- the data rows weighted (3 M D), f and g = J^T r (2 x 3 M D);
- B = J^T J, symmetric: 3 M D (D + 1);
- the GMM prior: each component's triangular whitening d (d + 1) + 2 d,
  the chosen one's gradient 2 d^2; the diagonal regularisers 10 D;
- the direction: (cg + 2) products with B and their vector work,
  (cg + 2)(2 D^2 + 12 D);
- the trial point's cost: the forward kinematics (122 a joint) and the
  markers without the Jacobian, the prior's and regularisers' cost;
- the accept test and trust-region update, 20 D.
"""

from __future__ import annotations

import importlib.util
import os


def _rows():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "marker_rows.py")
    spec = importlib.util.spec_from_file_location("bench_count_rows", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sim_flops(st: dict) -> float:
    """The markers without the Jacobian, one frame."""
    f = sum(6 * st["featN"] + 24 * n + 24 + 6 * st["E"]
            for n in st["weights_per_vertex"])
    return f + 60 * st["M"]


def _prior_cost(st: dict) -> float:
    d = st["prior_dim"]
    return st["prior_components"] * (d * (d + 1) + 2 * d)


def frame_iteration_flops(st: dict, cg_iters: int) -> float:
    M, J, D, E = st["M"], st["J"], st["D"], st["E"]
    f = 276 * J
    if st["hands"]:
        f += 2 * st["hand_pca"] * st["hand_aa"] / st["hands"]
    f += _rows().frame_flops(st)
    if E and st["route"] == "tiled":
        f += 18 * J * E + sum(E * (24 + 6 * n)
                              for n in st["weights_per_vertex"]) + 54 * E * M
    f += 3 * 3 * M * D + 3 * M * D * (D + 1)
    f += _prior_cost(st) + 2 * st["prior_dim"] ** 2 + 10 * D
    f += (cg_iters + 2) * (2 * D * D + 12 * D)
    f += 122 * J + _sim_flops(st) + _prior_cost(st) + 10 * D
    return f + 20 * D
