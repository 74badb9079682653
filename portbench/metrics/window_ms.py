"""Device ms per volume of the sliding window's own work: the device
stretch of `dlka.window` less its `dlka.window.forward`s (upload, flips,
softmax and un-flip, blend, normalize, argmax, fetch, and the device
idle among them)."""

from portbench import spans


def read(ctx):
    recs = spans.records()
    whole = spans.per_unit_ms(ctx, recs, {"dlka.window"})
    forwards = spans.per_unit_ms(ctx, recs, {"dlka.window.forward"})
    return whole - forwards if whole is not None and forwards is not None else None
