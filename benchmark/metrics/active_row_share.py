"""The share of the frame rows the batched dogleg computed that belonged
to frames still active, in %: the program's counters at each iteration of
a batch of K frames (the full batch or a compaction bucket), 100 x the
sum of ("gn.active", K) over the sum of K x ("gn.step", K). The rest are
done frames carried along until the next compaction. Read from a traced
run on the device; a record without device activity reads nothing."""


def read(record):
    counts = record.get("launch_frames") or {}
    active, steps = counts.get("gn.active"), counts.get("gn.step")
    if not record.get("device_events") or not active or not steps:
        return None
    rows = sum(int(K) * n for K, n in steps.items())
    if rows <= 0:
        return None
    return 100.0 * sum(active.values()) / rows
