"""Per-layer metric kernels.roofline_share.train: readers.kernels_roofline over the cell's traced window."""

from portbench import readers


def read(ctx):
    return readers.kernels_roofline(ctx)
