"""Dogleg iterations a frame, summed over a solve's phases: every dogleg
solve's frame-iterations (`SolveResult.iterations` summed, the anchor
phases over the anchors only) over the frames solved."""


def read(record):
    solves = record.get("solves") or []
    calls = record.get("calls") or []
    frames = sum(s["frames"] for s in solves)
    if not frames or not calls:
        return None
    return sum(c["frame_iters"] for c in calls) / frames
