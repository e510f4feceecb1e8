"""The device's idle time inside the program's `stageii.solve` while the
innermost program span open is one of the stage-ii schedule's (the solve
itself with no finer span open, its phases, the rigid init, the velocity
anchors, the slerp, the report and the finalize), as a share of the
traced window, in %."""

from harness.program_spans import idle_share


def read(record):
    return idle_share(record, "schedule")
