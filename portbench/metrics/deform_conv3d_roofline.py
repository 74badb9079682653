"""Hand kernel `deform_conv3d`'s share of its roofline, in % (`counts.py`)."""

from portbench.counts import roofline_share


def read(ctx):
    return roofline_share(ctx, "deform_conv3d", r"deform_conv3d_kernel(?:[(<]|$)")
