"""Windows attended per unit by MaxViT's block and grid attention: Σ of
the `dlka.maxvit.windows` counter's deltas that the program stores on
its unit spans (`counts`). None where the program keeps no such counter
or no window was attended."""

from portbench import spans


def read(ctx):
    units = spans.units(spans.records())
    if not units or any(getattr(r, "counts", None) is None for r in units):
        return None
    n = sum(r.counts.get("dlka.maxvit.windows", 0) for r in units)
    return n / ctx.units if n else None
