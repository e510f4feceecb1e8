"""Device-to-host reads of the dogleg loop's condition, a solve: the mean
of `StageIIResult.host_syncs` over the traced window's solves."""


def read(record):
    solves = record.get("solves") or []
    if not solves:
        return None
    return sum(s["host_syncs"] for s in solves) / len(solves)
