"""Each count of `counts/` against a brute-force count at tiny shapes: the
same algorithm walked operation by operation (an FMA is 2)."""

import itertools

import pytest

import bench_common  # noqa: F401
from harness.spec import count


def _structure(route, E, hands=2):
    J = 5
    return dict(M=2, J=J, featN=9 * (J - 1), body_dof=9,
                hand_pca=2 * hands, hand_aa=3 * J - 9 if hands else 0,
                hands=hands, E=E, D=3 + 9 + 2 * hands + E,
                prior_dim=4, prior_components=3, route=route,
                weights_per_vertex=[1, 2, 2, 3, 1, 2],
                ancestors_per_vertex=[1, 3, 2, 4, 2, 3])


def _brute_rows(st):
    """Walk the marker rows' operations: per frame vertex and per marker."""
    f = 0
    J, E, route = st["J"], st["E"], st["route"]
    for n, a in zip(st["weights_per_vertex"], st["ancestors_per_vertex"]):
        for _row, _p in itertools.product(range(3), range(st["featN"])):
            f += 2                                   # pose blend MAC
        f += 2 * 12 * n                              # T = sum w [G | t]
        f += 2 * 9 + 6                               # T v + t + trans
        for _ in range(a):
            f += 2 * 3 * n                           # weighted point
            f += 3 * 9                               # three cross products
        for _ in range(J - 1):
            f += 2 * 3 * 9 * 3                       # posedirs block x dfeat
            f += 3 * 2 * 9                           # three columns by T
        if route == "ext":
            f += E * (6 + 18 + 6 * n)
        elif route == "tiled":
            f += 3
    for _ in range(st["M"]):
        f += 60 + 270
        f += 3 * J * 3 * 2 * 9                       # columns over vertices
        if st["hands"]:
            per = st["hand_pca"] // st["hands"]
            for _r, _c in itertools.product(range(3), range(st["hand_aa"])):
                f += 2 * per
        f += 54 * E if route == "ext" else (162 if route == "tiled" else 0)
    return f


@pytest.mark.parametrize("route,E", [("", 0), ("ext", 8), ("tiled", 20)])
def test_marker_rows_matches_brute_force(route, E):
    st = _structure(route, E)
    mr = count("marker_rows")
    assert mr.frame_flops(st) == _brute_rows(st)
    ops, nbytes = mr.launch(st, 7)
    assert ops == 7 * _brute_rows(st)
    cols = st["D"] - (E if route == "tiled" else 0)
    per_frame = (12 * st["J"] + st["featN"] + 3 + E + 3 * st["M"]
                 + 3 * st["M"] * cols + (54 * st["M"] if route == "tiled"
                                         else 0))
    assert nbytes == 4 * (7 * per_frame + 3 * st["M"] * (
        3 + 3 * st["featN"] + 2 * st["J"] + 1))


@pytest.mark.parametrize("route,E,hands", [("", 0, 2), ("tiled", 20, 2),
                                           ("", 0, 0)])
def test_frame_iteration_matches_brute_force(route, E, hands):
    st = _structure(route, E, hands)
    it = count("stageii_iteration")
    M, J, D = st["M"], st["J"], st["D"]
    d, K = st["prior_dim"], st["prior_components"]
    for cg in (0, 3):
        f = 276 * J
        if hands:
            f += 2 * (st["hand_pca"] // hands) * (st["hand_aa"] // hands) \
                * hands
        f += _brute_rows(st)
        if route == "tiled":
            f += 18 * J * E
            for n in st["weights_per_vertex"]:
                f += E * (24 + 6 * n)
            f += 54 * E * M
        f += 9 * M * D                              # weight, f, g
        for _r, i, j in itertools.product(range(3 * M), range(D), range(D)):
            if j >= i:
                f += 2                              # B's upper triangle
        prior_cost = K * (d * (d + 1) + 2 * d)
        f += prior_cost + 2 * d * d + 10 * D
        f += (cg + 2) * (2 * D * D + 12 * D)
        f += 122 * J
        for n in st["weights_per_vertex"]:
            f += 6 * st["featN"] + 24 * n + 24 + 6 * E
        f += 60 * M + prior_cost + 10 * D + 20 * D
        assert it.frame_iteration_flops(st, cg) == pytest.approx(f, rel=0,
                                                                 abs=1e-6)
