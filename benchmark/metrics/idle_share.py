"""The share of the traced window in which nothing runs on the device:
1 - (the union of the profiler's device intervals) / the window, in %."""

from harness.trace import busy_seconds


def read(record):
    ev, secs = record.get("device_events"), record.get("window_s")
    if not ev or not secs:
        return None
    lo, hi = record["window_ns"]
    return 100.0 * (1.0 - busy_seconds(ev, lo, hi) / secs)
