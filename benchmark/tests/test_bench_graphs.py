"""The reader of the share of rows replayed from CUDA graphs
(`metrics/graph_row_share.py`) on hand-made records, after
test_bench_spans.py: a value, and nothing without device events or
without the program's counter."""

import pytest

from bench_common import BENCH
from harness.spec import metric_reader


def _read(record):
    return metric_reader("graph_row_share", BENCH)(record)


def _record():
    return {"device_events": [("k", 0, 1)],
            "launch_frames": {"gn.step": {4096: 30, 2048: 10, 128: 4},
                              "gn.graph": {4096: 28, 2048: 9, 128: 3},
                              "gn.active": {4096: 100_000, 2048: 15_000,
                                            128: 300},
                              "marker_rows<jac>": {4096: 30}}}


def test_graph_row_share_on_a_hand_made_record():
    rows = 4096 * 30 + 2048 * 10 + 128 * 4
    replayed = 4096 * 28 + 2048 * 9 + 128 * 3
    got = _read(_record())
    assert got == pytest.approx(100.0 * replayed / rows)
    assert 0 < got < 100


def test_graph_row_share_reads_nothing_without_device_events():
    """The counters alone, without a device trace (a CPU run)."""
    assert _read(dict(_record(), device_events=[])) is None


def test_graph_row_share_reads_nothing_without_the_counter():
    """A program without the graphs: no ("gn.graph", K) key, or no
    counters at all."""
    rec = _record()
    del rec["launch_frames"]["gn.graph"]
    assert _read(rec) is None
    assert _read({"device_events": [("k", 0, 1)]}) is None
    assert _read({}) is None
