"""Set-up: process start to the first timed step (kernels loaded or
built, inputs made, the graph built and warmed)."""

UNIT = "s"


def read(run):
    return run.setup_s
