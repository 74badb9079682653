"""The share of the traced stretch's steps that the program served by
replaying its CUDA graphs, in %: Σ of the `dlka.step.graphed` counter's
deltas that the program stores on its unit spans, over the units. None
where the program keeps no such counter."""

from portbench import spans

COUNTER = "dlka.step.graphed"


def read(ctx):
    from deformablelka_tpu_torch import profiling

    counts = getattr(profiling, "counts", None)
    if counts is None or COUNTER not in counts():
        return None
    units = spans.units(spans.records())
    if not units or any(getattr(r, "counts", None) is None for r in units):
        return None
    return 100.0 * sum(r.counts.get(COUNTER, 0) for r in units) / ctx.units
