"""Per-layer metric device.idle_share.serve: readers.idle_share over the cell's traced window."""

from portbench import readers


def read(ctx):
    return readers.idle_share(ctx)
