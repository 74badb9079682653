"""Device ms per step of MaxViT's block and grid attention, Σ
`dlka.maxvit.attention` (partition, attention and reverse; in the
forward: the 2D model keeps its activations, no recompute)."""

from portbench import spans


def read(ctx):
    return spans.phase_ms(ctx, "dlka.maxvit.attention")
