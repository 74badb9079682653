"""The program's own span records, as the readers of `program_span` and
`program_counter` metrics take them: `deformablelka_tpu_torch.profiling.spans()`
after the traced stretch. The program records spans only while
`torch.profiler` records, so these are the stretch's own.

A record's device stretch is the time between its two CUDA events: from
when the stream reaches the span's start to when it reaches its end,
device idle inside the span included. A record without events (off the
card) has none, and a program that keeps no spans gives no records: the
readers then return None.
"""

from __future__ import annotations


def records() -> list:
    """The program's span records; [] where it keeps none."""
    from deformablelka_tpu_torch import profiling

    read = getattr(profiling, "spans", None)
    return list(read()) if read is not None else []


def device_ms(rec) -> float | None:
    if getattr(rec, "start", None) is None or getattr(rec, "end", None) is None:
        return None
    return rec.start.elapsed_time(rec.end)


def units(recs) -> list:
    """The unit spans among the records (a step, a volume)."""
    return [r for r in recs if getattr(r, "unit_span", False)]


def unit_kind(recs) -> str | None:
    """The name of the unit span the records hold ("dlka.step",
    "dlka.window"), or None."""
    found = units(recs)
    return found[0].name if found else None


def per_unit_ms(ctx, recs, names) -> float | None:
    """Σ of the device stretches of the records named in `names`, ms per
    unit of the traced stretch; None where one has no device stretch or
    none is found."""
    times = [device_ms(r) for r in recs if r.name in names]
    if not times or any(t is None for t in times):
        return None
    return sum(times) / ctx.units


def phase_ms(ctx, *names) -> float | None:
    return per_unit_ms(ctx, records(), set(names))
