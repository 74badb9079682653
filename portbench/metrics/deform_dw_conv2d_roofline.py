"""Hand kernel `deform_dw_conv2d`'s share of its roofline, in % (`counts.py`)."""

from portbench.counts import roofline_share


def read(ctx):
    return roofline_share(ctx, "deform_dw_conv2d", r"deform_dw_conv2d_kernel(?:[(<]|$)")
