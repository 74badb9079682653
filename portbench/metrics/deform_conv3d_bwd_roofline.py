"""Hand kernel `deform_conv3d_bwd`'s share of its roofline, in % (`counts.py`)."""

from portbench.counts import roofline_share


def read(ctx):
    return roofline_share(ctx, "deform_conv3d_bwd", r"deform_bwd_data_kernel(?:[(<]|$)")
