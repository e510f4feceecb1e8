"""The fused dogleg direction kernel as a share of its roofline: the least
time its launches need (the larger of their operations at the card's
float32 peak and their bytes at its memory bandwidth,
`counts/dogleg_direction.py` at each launch's systems N, the structure's
width D and its CG iterations I, from the program's counters
"dogleg_direction<cg=I>" by N) over the device time of the kernel's
`<false, ..>` instantiations in the trace, in %."""

import re

KERNEL = re.compile(r"dogleg_direction_kernel<\s*false\s*,")
COUNTER = re.compile(r"dogleg_direction<cg=(\d+)>$")


def read(record):
    st, peaks = record.get("structure"), record.get("peaks")
    if not st or not peaks:
        return None
    secs = sum(e - s for n, s, e in record.get("device_events") or []
               if KERNEL.search(n)) / 1e9
    launches = [(int(m.group(1)), by_n) for name, by_n in
                (record.get("launch_frames") or {}).items()
                for m in [COUNTER.match(name)] if m]
    if not launches or secs <= 0:
        return None
    count = record["count"]("dogleg_direction")
    least = 0.0
    for iters, by_n in launches:
        for n_sys, n in by_n.items():
            ops, nbytes = count.launch(st["D"], int(n_sys), iters)
            least += n * max(ops / peaks["fp32_flops"],
                             nbytes / peaks["hbm_bytes"])
    return 100.0 * least / secs
