"""Device ms per step of the backward (`dlka.step.backward`): remat's
recompute, the VJPs, kernel 3 and the chain's grouped wgrad."""

from portbench import spans


def read(ctx):
    return spans.phase_ms(ctx, "dlka.step.backward")
