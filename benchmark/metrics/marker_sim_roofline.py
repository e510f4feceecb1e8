"""The trial point's marker kernel (the markers without their Jacobian) of
the cell's route, as a share of its roofline: the least time its launches
need (the larger of their operations at the card's float32 peak and their
bytes at its memory bandwidth, `counts/marker_sim.py`, from each launch's
frames) over their device time in the trace, in %."""

import re

# the program's launch counter and its CUDA kernel, by the kernels' route
ROUTES = {"": ("marker_rows<sim>", "false, false, false, false"),
          "ext": ("marker_rows<sim,ext>", "false, true, false, false"),
          "tiled": ("marker_rows<sim,tiled>", "false, false, true, false")}


def read(record):
    st, peaks = record.get("structure"), record.get("peaks")
    if not st or not peaks or st["route"] not in ROUTES:
        return None
    counter, flags = ROUTES[st["route"]]
    launches = (record.get("launch_frames") or {}).get(counter)
    pat = re.compile(r"marker_rows_kernel<\s*" + r",\s*".join(
        flags.split(", ")) + r"\s*>")
    secs = sum(e - s for n, s, e in record.get("device_events") or []
               if pat.search(n)) / 1e9
    if not launches or secs <= 0:
        return None
    count = record["count"]("marker_sim")
    least = 0.0
    for frames, n in launches.items():
        ops, nbytes = count.launch(st, int(frames))
        least += n * max(ops / peaks["fp32_flops"],
                         nbytes / peaks["hbm_bytes"])
    return 100.0 * least / secs
