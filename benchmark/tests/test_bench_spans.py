"""The readers of the program's spans and counters: each on a hand-made
record, the three idle metrics as a partition of the idle time inside the
program's `stageii.solve`, nothing read from a program without them, and
`counts/dogleg_direction.py` against a brute-force count."""

import random

import pytest

from bench_common import BENCH
from harness.peaks import PEAKS
from harness.spec import count, metric_reader

IDLE = ("system_idle_share", "dogleg_idle_share", "schedule_idle_share")
NEW = IDLE + ("active_row_share", "dogleg_direction_roofline")


def _read(name, record):
    return metric_reader(name, BENCH)(record)


def _traced():
    """One solve in a 1000 ns window: device idle 10 ns before it, 50 ns
    after it, and inside it 60 + 30 + 20 ns under schedule spans, 15 + 25
    under the system's, 30 + 85 under the dogleg's."""
    host = [("bench.window", 0, 1000), ("bench.solve", 90, 905),
            ("stageii.solve", 100, 900), ("stageii.phase.step1", 140, 800),
            ("gn.solve", 160, 790), ("gn.active_read", 170, 200),
            ("aten::item", 171, 199), ("gn.step", 210, 600),
            ("stageii.system", 220, 400), ("stageii.data_rows", 230, 300),
            ("aten::mul", 240, 260), ("gn.direction", 410, 500),
            ("stageii.cost", 510, 550), ("gn.post_step", 560, 590),
            ("gn.compact", 620, 700), ("stageii.finalize", 820, 880)]
    dev = [("k", 0, 50), ("k", 60, 120), ("k", 180, 235), ("k", 250, 420),
           ("k", 450, 515), ("k", 540, 565), ("k", 650, 830),
           ("k", 860, 880), ("k", 950, 1000)]
    return {"host_events": host, "device_events": dev,
            "window_ns": (0, 1000), "window_s": 1e-6}


def test_idle_readers_on_a_hand_made_record():
    rec = _traced()
    assert _read("system_idle_share", rec) == pytest.approx(4.0)
    assert _read("dogleg_idle_share", rec) == pytest.approx(11.5)
    assert _read("schedule_idle_share", rec) == pytest.approx(11.0)
    # the rest of the idle time lies outside the solve
    assert _read("idle_share", rec) == pytest.approx(26.5 + 6.0)


def _random_record(rng):
    """Solves of nested program spans over random device activity."""
    host, t = [("bench.window", 0, 100_000)], 500
    names = ["stageii.phase.step2", "gn.solve", "gn.step", "stageii.system",
             "stageii.prior", "gn.direction", "stageii.cost", "gn.compact",
             "stageii.slerp", "aten::mul"]

    def nest(lo, hi, depth):
        t = lo
        while depth < 4 and t < hi - 40:
            a = rng.randrange(t + 1, hi - 20)
            b = rng.randrange(a + 5, min(hi, a + (hi - lo) // 2 + 10))
            host.append((rng.choice(names), a, b))
            nest(a, b, depth + 1)
            t = b
    while t < 95_000:
        a, b = t + rng.randrange(0, 300), t + rng.randrange(2_000, 9_000)
        host.append(("stageii.solve", a, b))
        nest(a, b, 0)
        t = b
    host.sort(key=lambda r: r[1])
    dev, t = [], 0
    while t < 100_000:
        a = t + rng.randrange(0, 60)
        dev.append(("k", a, a + rng.randrange(1, 80)))
        t = a + rng.randrange(1, 90)
    return {"host_events": host, "device_events": dev,
            "window_ns": (0, 100_000), "window_s": 1e-4}


def _idle_inside_solves(rec):
    """Idle ns inside the solves, point by point."""
    busy, inside = set(), set()
    for _, s, e in rec["device_events"]:
        busy.update(range(s, e))
    for n, s, e in rec["host_events"]:
        if n == "stageii.solve":
            inside.update(range(s, e))
    return len(inside - busy)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_idle_readers_partition_the_idle_time_in_solves(seed):
    rec = _random_record(random.Random(seed))
    shares = [_read(n, rec) for n in IDLE]
    assert all(s >= 0 for s in shares)
    assert sum(shares) == pytest.approx(
        100.0 * _idle_inside_solves(rec) / 100_000)
    assert sum(shares) <= _read("idle_share", rec) + 1e-9


def test_active_row_share_on_a_hand_made_record():
    rec = {"device_events": [("k", 0, 1)],
           "launch_frames": {"gn.step": {64: 10, 16: 5},
                             "gn.active": {64: 500, 16: 40},
                             "marker_rows<jac>": {64: 10}}}
    assert _read("active_row_share", rec) == pytest.approx(
        100.0 * 540 / (64 * 10 + 16 * 5))
    # the counters alone, without a device trace (a CPU run), read nothing
    assert _read("active_row_share", dict(rec, device_events=[])) is None


def test_direction_roofline_on_a_hand_made_record():
    fused = "(anonymous namespace)::dogleg_direction_kernel<false, false>(int)"
    rec = {"structure": {"D": 117}, "peaks": PEAKS["H100"],
           "count": lambda name: count(name, BENCH),
           "launch_frames": {"dogleg_direction<cg=24>": {4096: 2},
                             "dogleg_direction<cg=128>": {512: 1},
                             "gn.step": {4096: 3}},
           "device_events": [(fused, 0, 400_000), (fused, 500_000, 900_000),
                             (fused, 1_000_000, 1_300_000),
                             ("dogleg_direction_kernel<true, false>(int)",
                              0, 10 ** 9)]}
    dd, p = count("dogleg_direction", BENCH), PEAKS["H100"]
    least = 0.0
    for iters, n_sys, n in ((24, 4096, 2), (128, 512, 1)):
        ops, nbytes = dd.launch(117, n_sys, iters)
        least += n * max(ops / p["fp32_flops"], nbytes / p["hbm_bytes"])
    got = _read("dogleg_direction_roofline", rec)
    assert got == pytest.approx(100.0 * least / 1.1e-3)
    assert 0 < got < 100


def test_no_reading_without_the_programs_spans_and_counters():
    """The parent program: its trace has no program spans and its counters
    no `gn.*` or `dogleg_direction<cg=..>` keys."""
    rec = _traced()
    rec["host_events"] = [h for h in rec["host_events"]
                          if not h[0].startswith(("stageii.", "gn."))]
    rec.update(structure={"D": 117}, peaks=PEAKS["H100"],
               count=lambda name: count(name, BENCH),
               launch_frames={"marker_rows<jac>": {4096: 3}})
    for name in NEW:
        assert _read(name, rec) is None, name
        assert _read(name, {}) is None, name


def _brute_direction(D, iters):
    """Walk the fused direction's operations, entry by entry."""
    f = 0

    def matvec():
        n = 0
        for _ in range(D):
            n += 1                     # the vector masked
            for _ in range(D):
                n += 2                 # a row's MAC
            n += 5                     # masked, identity, damping
        return n
    for _ in range(D):
        f += 4                         # masked diagonal, its sum
    f += matvec()                      # the warm start's residual
    for _ in range(D):
        f += 1 + 1 + 4 + 1 + 2         # 1/diag, r, two squares, z, r.z
    for _ in range(iters):
        f += matvec()
        for _ in range(D):
            f += 2 + 4 + 1 + 2 + 2     # pBp, x and r, z, rz, p
    f += matvec() + matvec()           # B g, B p
    for _ in range(D):
        f += 4 + 4 + 1 + 1 + 6 + 2 + 1 + 4
    return f


@pytest.mark.parametrize("D,iters", [(5, 0), (5, 3), (9, 2)])
def test_direction_count_matches_brute_force(D, iters):
    dd = count("dogleg_direction", BENCH)
    assert dd.system_flops(D, iters) == _brute_direction(D, iters)
    ops, nbytes = dd.launch(D, 7, iters)
    assert ops == 7 * _brute_direction(D, iters)
    assert nbytes == 7 * 4 * (D * D + 3 * D + 1 + 2 * D + 1)
