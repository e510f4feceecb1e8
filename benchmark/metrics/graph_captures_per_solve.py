"""CUDA graphs the batched dogleg captured, a solve: the program's
counter at each capture, the sum over K of ("gn.capture", K) over the
traced window's solves. A program that keeps its graphs from one solve to
the next captures only the shapes it has not met. Read from a traced run
on the device; a record without device activity, without solves, or
without the counter (a program that does not count its captures) reads
nothing."""


def read(record):
    captures = (record.get("launch_frames") or {}).get("gn.capture")
    solves = record.get("solves") or []
    if not record.get("device_events") or captures is None or not solves:
        return None
    return sum(captures.values()) / len(solves)
