"""Hand-kernel launches per unit: Σ of the `.launches` deltas of
`ops/kernels.py`'s wrappers that the program stores on its unit spans
(`dlka.step`, `dlka.window`). None off the card, where the unit spans
carry no device stretch."""

from portbench import spans


def read(ctx):
    units = spans.units(spans.records())
    if not units or any(spans.device_ms(r) is None or r.launches is None for r in units):
        return None
    return sum(sum(r.launches.values()) for r in units) / ctx.units
