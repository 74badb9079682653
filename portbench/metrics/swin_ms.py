"""Device ms per step of the Swin encoder's stages, Σ `dlka.swin.stage`
(each stage's blocks and patch merging, in the forward; the stage span
lies outside the checkpointed blocks, so the recompute adds nothing)."""

from portbench import spans


def read(ctx):
    return spans.phase_ms(ctx, "dlka.swin.stage")
