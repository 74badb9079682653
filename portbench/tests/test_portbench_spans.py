"""The readers of the program's spans and counters (`portbench/spans.py`,
`metrics/{forward,loss,backward,update,window}_ms.py`,
`metrics/hand_launches.py`) on synthetic span records: each gives its
number per unit; each returns None where the records carry no device
stretch (the CPU), and where the program keeps no spans."""

from types import SimpleNamespace

import pytest

from deformablelka_tpu_torch import profiling
from portbench import harness


class Event:
    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


def rec(name, t0, t1, launches=None, timed=True):
    """A span record; those given `launches` are unit spans."""
    return SimpleNamespace(name=name, unit_span=launches is not None,
                           start=Event(t0) if timed else None,
                           end=Event(t1) if timed else None, launches=launches)


def steps(timed=True):
    """Two steps of 100 ms: forward 30, loss 2, backward 60, clip 1, update 3."""
    out = []
    for k in range(2):
        t = 100.0 * k
        out += [rec("dlka.step", t, t + 100, {"deform_conv3d": 42, "dw_chain3d": 42,
                                              "deform_conv3d_bwd": 21}, timed)]
        for name, d in (("forward", 30), ("loss", 2), ("backward", 60), ("clip", 1),
                        ("update", 3)):
            out.append(rec(f"dlka.step.{name}", t, t + d, timed=timed))
            t += d
    return out


def windows(timed=True):
    """Two volumes of 1000 ms, each 8 forwards of 200 ms and the rest."""
    out = []
    for k in range(2):
        t = 1000.0 * k
        out.append(rec("dlka.window", t, t + 1000, {"deform_conv3d": 168, "dw_chain3d": 168},
                       timed))
        out.append(rec("dlka.window.upload", t, t + 10, timed=timed))
        for i in range(8):
            out.append(rec("dlka.window.tile", t, t + 120, timed=timed))
            out.append(rec("dlka.window.forward", t + 1, t + 26, timed=timed))
            t += 120
    return out


def read(metric, records, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: records)
    return harness.module("metrics", metric).read(SimpleNamespace(units=2))


@pytest.mark.parametrize("metric,records,want", [
    ("forward_ms", steps, 30.0),
    ("loss_ms", steps, 2.0),
    ("backward_ms", steps, 60.0),
    ("update_ms", steps, 4.0),
    ("hand_launches", steps, 105.0),
    ("forward_ms", windows, 200.0),
    ("window_ms", windows, 800.0),
    ("hand_launches", windows, 336.0),
])
def test_reader_gives_its_number(metric, records, want, monkeypatch):
    assert read(metric, records(), monkeypatch) == pytest.approx(want)


@pytest.mark.parametrize("metric,records", [
    ("forward_ms", steps), ("loss_ms", steps), ("backward_ms", steps), ("update_ms", steps),
    ("hand_launches", steps), ("forward_ms", windows), ("window_ms", windows),
    ("hand_launches", windows)])
def test_reader_gives_none_without_device_stretch(metric, records, monkeypatch):
    assert read(metric, records(timed=False), monkeypatch) is None


@pytest.mark.parametrize("metric", ["forward_ms", "loss_ms", "backward_ms", "update_ms",
                                    "window_ms", "hand_launches"])
def test_reader_gives_none_without_spans(metric, monkeypatch):
    assert read(metric, [], monkeypatch) is None
    monkeypatch.delattr(profiling, "spans")      # a program from before its spans
    assert harness.module("metrics", metric).read(SimpleNamespace(units=2)) is None


def test_window_metrics_find_nothing_in_steps(monkeypatch):
    assert read("window_ms", steps(), monkeypatch) is None
    assert read("loss_ms", windows(), monkeypatch) is None


def test_unit_spans_are_found_by_their_marker():
    from portbench import spans

    renamed = [SimpleNamespace(**{**vars(r), "name": "x.unit"}) if r.unit_span else r
               for r in steps()]
    assert [r.name for r in spans.units(renamed)] == ["x.unit"] * 2
    assert spans.unit_kind(renamed) == "x.unit"
    assert spans.units([SimpleNamespace(name="dlka.step")]) == []
