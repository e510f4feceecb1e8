"""Device kernels launched a solve: the kernels (copies and fills left
out) the profiler saw on the device in the traced window, over its
solves."""

from harness.trace import is_kernel


def read(record):
    solves = record.get("solves") or []
    ev = record.get("device_events") or []
    n = sum(1 for name, _, _ in ev if is_kernel(name))
    if not solves or not n:
        return None
    return n / len(solves)
