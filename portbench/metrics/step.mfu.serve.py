"""Per-layer metric step.mfu.serve: readers.step_mfu over the cell's traced window."""

from portbench import readers


def read(ctx):
    return readers.step_mfu(ctx)
