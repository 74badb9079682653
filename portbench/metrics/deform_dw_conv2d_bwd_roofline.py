"""Hand kernel `deform_dw_conv2d_bwd`'s share of its roofline, in % (`counts.py`)."""

from portbench.counts import roofline_share


def read(ctx):
    return roofline_share(ctx, "deform_dw_conv2d_bwd", r"deform_dw_bwd_data_kernel(?:[(<]|$)")
