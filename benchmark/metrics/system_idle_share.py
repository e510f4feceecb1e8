"""The device's idle time inside the program's `stageii.solve` while the
innermost program span open is the system assembly's (`stageii.system`
and its data rows, normal equations and prior, and `stageii.cost`), as a
share of the traced window, in %: the host's assembly of the
Gauss-Newton system holding the device back."""

from harness.program_spans import idle_share


def read(record):
    return idle_share(record, "system")
