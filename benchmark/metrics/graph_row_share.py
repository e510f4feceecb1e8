"""The share of the frame rows the batched dogleg computed that came from
a CUDA graph's replay, in %: the program's counters at each iteration of a
batch of K frames, 100 x the sum of K x ("gn.graph", K) over the sum of K x
("gn.step", K). The rest ran eagerly: the first iteration at each batch
shape, and every iteration of a program without the graphs. Read from a
traced run on the device; a record without device activity, or without
the counter, reads nothing."""


def read(record):
    counts = record.get("launch_frames") or {}
    graph, steps = counts.get("gn.graph"), counts.get("gn.step")
    if not record.get("device_events") or not graph or not steps:
        return None
    rows = sum(int(K) * n for K, n in steps.items())
    if rows <= 0:
        return None
    return 100.0 * sum(int(K) * n for K, n in graph.items()) / rows
