"""Hand kernel `dw_chain3d`'s share of its roofline, in % (`counts.py`)."""

from portbench.counts import roofline_share


def read(ctx):
    return roofline_share(ctx, "dw_chain3d", r"dw_chain3d_kernel(?:[(<]|$)")
