"""Device ms per unit of the model's forwards, from the program's spans:
`dlka.step.forward` in a training step, Σ `dlka.window.forward` over a
volume's tiles (`portbench/spans.py`)."""

from portbench import spans


def read(ctx):
    recs = spans.records()
    kind = spans.unit_kind(recs)
    return spans.per_unit_ms(ctx, recs, {kind + ".forward"}) if kind else None
