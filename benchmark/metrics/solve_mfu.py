"""The whole stage-ii solve's share of the card's float32 peak: the
operations its frame-iterations need (`counts/stageii_iteration.py` at each
dogleg solve's CG iterations, times the frame-iterations the solver
reports) over the traced window's time, in %."""


def read(record):
    calls, peaks = record.get("calls"), record.get("peaks")
    st, secs = record.get("structure"), record.get("window_s")
    if not calls or not peaks or not st or not secs:
        return None
    count = record["count"]("stageii_iteration")
    ops = sum(c["frame_iters"]
              * count.frame_iteration_flops(st, c["cg_iters"])
              for c in calls)
    if ops <= 0:
        return None
    return 100.0 * ops / (secs * peaks["fp32_flops"])
