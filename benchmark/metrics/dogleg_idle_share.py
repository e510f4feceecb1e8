"""The device's idle time inside the program's `stageii.solve` while the
innermost program span open is one of the batched dogleg's (`gn.solve`,
`gn.active_read`, `gn.step`, `gn.direction`, `gn.post_step`,
`gn.compact`, `gn.scatter`), as a share of the traced window, in %: the
solver loop's host reads, steps and compaction holding the device back."""

from harness.program_spans import idle_share


def read(record):
    return idle_share(record, "dogleg")
