"""The joint-quantities kernel with the Jacobian of the cell's route, as a
share of its roofline: the least time its launches need (the larger of
their operations at the card's float32 peak and their bytes at its memory
bandwidth, `counts/fk_smalls.py`, from each launch's frames) over their
device time in the trace, in %."""

import re

# the program's launch counter and its CUDA kernel, by the kernels' route
ROUTES = {"": ("fk_smalls<jac>", "true, false, false"),
          "ext": ("fk_smalls<jac,ext>", "true, true, false"),
          "tiled": ("fk_smalls<jac,tiled>", "true, false, true")}


def read(record):
    st, peaks = record.get("structure"), record.get("peaks")
    if not st or not peaks or st["route"] not in ROUTES:
        return None
    counter, flags = ROUTES[st["route"]]
    launches = (record.get("launch_frames") or {}).get(counter)
    pat = re.compile(r"fk_smalls_kernel<\s*" + r",\s*".join(
        flags.split(", ")) + r"\s*>")
    secs = sum(e - s for n, s, e in record.get("device_events") or []
               if pat.search(n)) / 1e9
    if not launches or secs <= 0:
        return None
    count = record["count"]("fk_smalls")
    least = 0.0
    for frames, n in launches.items():
        ops, nbytes = count.launch(st, int(frames), True)
        least += n * max(ops / peaks["fp32_flops"],
                         nbytes / peaks["hbm_bytes"])
    return 100.0 * least / secs
