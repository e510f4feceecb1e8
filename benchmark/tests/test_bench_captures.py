"""The reader of the graphs captured a solve
(`metrics/graph_captures_per_solve.py`) on hand-made records, after
test_bench_graphs.py: a value, zero where the counter is there at zero,
and nothing without device events, solves or the program's counter."""

import pytest

from bench_common import BENCH
from harness.spec import metric_reader


def _read(record):
    return metric_reader("graph_captures_per_solve", BENCH)(record)


def _record(captures):
    return {"device_events": [("k", 0, 1)],
            "solves": [{"frames": 4096, "host_syncs": 240}] * 4,
            "launch_frames": {"gn.step": {4096: 30, 2048: 10, 128: 4},
                              "gn.graph": {4096: 28, 2048: 9, 128: 3},
                              "gn.capture": captures}}


def test_graph_captures_per_solve_on_a_hand_made_record():
    assert _read(_record({4096: 3, 2048: 2, 128: 1})) == pytest.approx(1.5)


def test_graph_captures_per_solve_reads_zero_where_none_was_captured():
    """The counter is there at zero: every stage found its graph made."""
    assert _read(_record({4096: 0, 2048: 0, 128: 0})) == 0.0


def test_graph_captures_per_solve_reads_nothing_without_the_counter():
    """A program that does not count its captures, a record without
    device events (a CPU run) or without solves."""
    rec = _record({4096: 1})
    del rec["launch_frames"]["gn.capture"]
    assert _read(rec) is None
    assert _read(dict(_record({4096: 1}), device_events=[])) is None
    assert _read(dict(_record({4096: 1}), solves=[])) is None
    assert _read({}) is None
