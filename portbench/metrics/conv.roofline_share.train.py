"""Per-layer metric conv.roofline_share.train: readers.conv_roofline over the cell's traced window."""

from portbench import readers


def read(ctx):
    return readers.conv_roofline(ctx)
