"""Device ms per step of the decoder's deformable LKA gates, Σ
`dlka.lka2d` (the two depthwise deform convs, the 1×1 and the product;
in the forward)."""

from portbench import spans


def read(ctx):
    return spans.phase_ms(ctx, "dlka.lka2d")
