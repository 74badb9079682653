"""Device ms per step of the gradient clip and the SGD update
(`dlka.step.clip` + `dlka.step.update`)."""

from portbench import spans


def read(ctx):
    return spans.phase_ms(ctx, "dlka.step.clip", "dlka.step.update")
