"""Device ms per step of the deep-supervision loss (`dlka.step.loss`)."""

from portbench import spans


def read(ctx):
    return spans.phase_ms(ctx, "dlka.step.loss")
