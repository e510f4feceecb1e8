"""The SMPL+H DMPL configuration's cell and the two kernel rooflines it
brought: the `fk_smalls` and `marker_sim` counts against brute force on
each route (the rotation and its derivative walked as the kernel computes
them, a multiply, an add, sqrt, sin, cos and a division 1 each; the
products as MACs, 2 each), both metrics' readings of hand-built records,
and the new cell, configuration and limits found by name."""

import itertools
import json
import os

import pytest

import bench_common  # noqa: F401
from bench_common import BENCH, ROOT
from harness.spec import count, load_cell, metric_reader

CELL = "smplh_dmpl8.capture4k"
PEAKS = {"fp32_flops": 67e12, "hbm_bytes": 3.35e12}


def _structure(route, E, J=5):
    return dict(M=2, J=J, featN=9 * (J - 1), body_dof=9, hand_pca=4,
                hand_aa=3 * J - 9, hands=2, E=E, D=3 + 9 + 4 + E,
                prior_dim=4, prior_components=3, route=route,
                weights_per_vertex=[1, 2, 2, 3, 1, 2],
                ancestors_per_vertex=[1, 3, 2, 4, 2, 3])


class Tally:
    """A number that counts the operations made with it."""
    ops = 0

    def __init__(self, v=0.0):
        self.v = v

    def _op(self, other):
        Tally.ops += 1
        return Tally()

    __add__ = __radd__ = __sub__ = __rsub__ = _op
    __mul__ = __rmul__ = __truediv__ = __rtruediv__ = _op

    def __neg__(self):
        return self


def _one(fn):
    """fn as a one-operand operation (sqrt, sin, cos)."""
    Tally.ops += 1
    return Tally()


def _walk_rotation(with_jac):
    """Operations of csrc/common.cuh's `rodrigues` (and `rodrigues_grad`)
    walked with Tally numbers."""
    Tally.ops = 0
    v = [Tally(), Tally(), Tally()]
    theta = _one(v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + 1e-12)
    half = 0.5 * theta
    w = _one(half)
    s = _one(half) / theta
    x, y, z = v[0] * s, v[1] * s, v[2] * s
    xx, yy, zz, xy, xz, yz = x * x, y * y, z * z, x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    [1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy), 2 * (xy + wz),
     1 - 2 * (xx + zz), 2 * (yz - wx), 2 * (xz - wy), 2 * (yz + wx),
     1 - 2 * (xx + yy)]
    rot = Tally.ops
    if not with_jac:
        return rot
    Tally.ops = 0
    g = (0.5 * w - s) / (theta * theta)
    for t in range(3):
        vt = v[t]
        dw = -0.5 * s * vt
        d = [g * v[i] * vt for i in range(3)]
        d[t] = d[t] + s
        dx, dy, dz = d
        dxx, dyy, dzz = 2 * x * dx, 2 * y * dy, 2 * z * dz
        dxy, dxz, dyz = dx * y + x * dy, dx * z + x * dz, dy * z + y * dz
        dwx, dwy, dwz = dw * x + w * dx, dw * y + w * dy, dw * z + w * dz
        [-2 * (dyy + dzz), 2 * (dxy - dwz), 2 * (dxz + dwy),
         2 * (dxy + dwz), -2 * (dxx + dzz), 2 * (dyz - dwx),
         2 * (dxz - dwy), 2 * (dyz + dwx), -2 * (dxx + dyy)]
    return rot, Tally.ops


def _macs(*shape):
    """2 a multiply-add over a loop nest of `shape`."""
    return 2 * sum(1 for _ in itertools.product(*map(range, shape)))


def _brute_fk(st, with_jac):
    """Walk one frame of fk_smalls joint by joint."""
    J, E, route = st["J"], st["E"], st["route"]
    rot, grad = _walk_rotation(True)
    f = 0
    for j in range(J):
        root = j == 0
        f += rot
        if route == "ext":
            f += _macs(2, E, 3)                      # offset and joint moved
        elif route == "tiled":
            f += 6
        if not root:
            f += _macs(3, 3, 3) + _macs(3, 3)        # G_p R, G_p t + b
            f += 3                                   # R - I
        f += _macs(3, 3)                             # A_tr
        if with_jac:
            f += grad
            f += _macs(3, 3, 3, 3)                   # dR R^T
            f += _macs(3, 3, 3)                      # u
            f += 2 * _macs(3, 3, 3, 3)               # Q . Q^T
            f += _macs(3, 3, 6)                      # W_tr
            if route == "ext":
                if not root:
                    f += _macs(E, 3, 3)              # S_e chain
                f += _macs(E, 3, 3)                  # datr
    return f


def test_rotation_walk_is_the_counts_constants():
    fk = count("fk_smalls")
    rot, grad = _walk_rotation(True)
    assert (rot, grad) == (fk.ROTATION, 157) == (_walk_rotation(False), 157)


@pytest.mark.parametrize("with_jac", [True, False])
@pytest.mark.parametrize("route,E", [("", 0), ("ext", 8), ("tiled", 20)])
def test_fk_smalls_matches_brute_force(route, E, with_jac):
    st = _structure(route, E)
    fk = count("fk_smalls")
    J = st["J"]
    assert fk.frame_flops(st, with_jac) == _brute_fk(st, with_jac)
    ops, nbytes = fk.launch(st, 7, with_jac)
    assert ops == 7 * _brute_fk(st, with_jac)
    read = 3 * J + {"": 0, "ext": E, "tiled": 6 * J}[route]
    written = 21 * J - 9
    if with_jac:
        written += 63 * J + {"": 0, "ext": 3 * E * J, "tiled": 9 * J}[route]
    tables = 4 * (6 * J + (6 * E * J if route == "ext" else 0)) + 8 * J
    assert nbytes == 7 * 4 * (read + written) + tables


def _brute_sim(st):
    f = 0
    for n in st["weights_per_vertex"]:
        f += _macs(3, st["featN"])                   # pose blend
        f += _macs(12, n)                            # T = sum w [G | t]
        f += _macs(3, 3) + 6                         # T v + t + trans
        if st["route"] == "ext":
            f += _macs(st["E"], 3)
        elif st["route"] == "tiled":
            f += 3
    return f + 60 * st["M"]


@pytest.mark.parametrize("route,E", [("", 0), ("ext", 8), ("tiled", 20)])
def test_marker_sim_matches_brute_force(route, E):
    st = _structure(route, E)
    ms = count("marker_sim")
    M, J = st["M"], st["J"]
    assert ms.frame_flops(st) == _brute_sim(st)
    ops, nbytes = ms.launch(st, 7)
    assert ops == 7 * _brute_sim(st)
    read = 12 * J + st["featN"] + 3 + {"": 0, "ext": E,
                                       "tiled": 9 * M}[route]
    per_vertex = 3 + 3 * st["featN"] + J + 1 + (3 * E if route == "ext"
                                                else 0)
    assert nbytes == 4 * (7 * (read + 3 * M) + 3 * M * per_vertex)


KERNELS = {
    "fk_smalls_roofline": ("fk_smalls", "fk_smalls<jac,ext>",
                           "void (anonymous namespace)::fk_smalls_kernel"
                           "<true, true, false>(float const*, int)"),
    "marker_sim_roofline": ("marker_sim", "marker_rows<sim,ext>",
                            "void (anonymous namespace)::marker_rows_kernel"
                            "<false, true, false, false>(int, int)"),
}


def _record(counter, kernel, launches, ns):
    return {"structure": _structure("ext", 8), "peaks": PEAKS,
            "launch_frames": {counter: launches} if counter else {},
            "device_events": [(kernel, 0, ns)] if kernel else [],
            "count": lambda name: count(name, BENCH)}


@pytest.mark.parametrize("metric", sorted(KERNELS))
def test_roofline_reads_none_without_its_launches(metric):
    name, counter, kernel = KERNELS[metric]
    read = metric_reader(metric, BENCH)
    assert read({}) is None
    assert read(_record(None, kernel, {}, 1000)) is None
    assert read(_record(counter, None, {64: 3}, 1000)) is None
    # another route's kernel is not this route's
    other = kernel.replace("true, false>", "false, true>").replace(
        "true, false, false>", "false, true, false>")
    assert read(_record(counter, other, {64: 3}, 1000)) is None


@pytest.mark.parametrize("metric", sorted(KERNELS))
def test_roofline_value_of_a_hand_built_record(metric):
    name, counter, kernel = KERNELS[metric]
    st = _structure("ext", 8)
    mod = count(name, BENCH)
    least = 0.0
    for frames, n in ((64, 3), (8, 2)):
        args = (st, frames, True) if name == "fk_smalls" else (st, frames)
        ops, nbytes = mod.launch(*args)
        least += n * max(ops / PEAKS["fp32_flops"],
                         nbytes / PEAKS["hbm_bytes"])
    got = metric_reader(metric, BENCH)(_record(counter, kernel,
                                               {64: 3, 8: 2}, 2_000))
    assert got == pytest.approx(100.0 * least / 2e-6, rel=1e-12)
    assert 0 < got < 100


def test_the_dmpl_cell_config_and_limits_are_found_by_name():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bj = json.load(fh)
    cell = load_cell(CELL, BENCH)
    assert cell.chips == 1 and cell.traffic["frames"] == 4096
    cfg = cell.config
    assert cfg["extras"] == {"kind": "dmpls", "count": 8, "start": 16,
                             "amplitude": 0.1}
    assert cfg["num_shape_dirs"] == cfg["num_betas"] + 8
    assert cfg["dof"] == 3 + cfg["body_pose_dof"] + 2 * cfg["dof_per_hand"] \
        + 8 == 125
    assert set(cell.limits) == {"sim_gap_mm", "pose_gap_mrad", "fit_mm",
                                "marker_fit_mm"}
    entry = {c["name"]: c for c in bj["configs"]}["smplh_dmpl8"]
    assert entry["reduced"] == [] and os.path.isfile(
        os.path.join(ROOT, entry["file"]))
    names = [m["name"] for m in cell.per_layer]
    assert names[-2:] == ["fk_smalls_roofline", "marker_sim_roofline"]
    assert len(names) == 14
    for m in bj["per_layer"]:
        assert CELL in m["workloads"]
    for name in ("fk_smalls", "marker_sim"):
        assert count(name, BENCH) is not None
