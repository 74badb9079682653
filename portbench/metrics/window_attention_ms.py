"""Device ms per step of the Swin blocks' window attention, Σ
`dlka.swin.attention` (roll, partition, attention, reverse, roll back),
in the forward and again in the remat recompute."""

from portbench import spans


def read(ctx):
    return spans.phase_ms(ctx, "dlka.swin.attention")
