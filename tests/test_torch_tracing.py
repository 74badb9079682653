"""The port's spans (`profiling.span`, `spans`) on the CPU: a shared no-op
with no profiler recording; under one, the training step's and the
sliding window's spans with their names, order, parents and unit
indices; the hand kernels' launch deltas on the unit spans; the spans in
`utils/profiling.trace`'s Chrome trace; the CUDA timing events of a
recording span, through a stand-in event class; outputs bitwise the same
with tracing on and off; and `device_profile` leaving the spans'
device-side annotations out of its kernels, through stand-in events.
"""

import json
from collections import deque
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deformablelka_tpu_torch import profiling
from deformablelka_tpu_torch.ops import kernels
from deformablelka_tpu_torch.inference.sliding_window import SlidingWindowInference
from deformablelka_tpu_torch.training.train_step import make_sgd, make_train_step
from deformablelka_tpu_torch.utils.profiling import trace

torch.set_num_threads(1)

STEP_PHASES = ["dlka.step.forward", "dlka.step.loss", "dlka.step.backward",
               "dlka.step.clip", "dlka.step.update"]
PATCH = (4, 8, 8)
VOLUME = (6, 10, 9, 1)     # pads to (6, 10, 9): 2 × 2 × 2 tiles at step 0.5
NCLS = 3


@pytest.fixture(autouse=True)
def fresh_spans():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


@pytest.fixture
def fake_launch(monkeypatch):
    """A stand-in for a hand kernel's launch: bumps `deform_conv3d.launches`
    (restored after the test)."""
    fn = kernels.deform_conv3d
    monkeypatch.setattr(fn, "launches", fn.launches)

    def launch():
        fn.launches += 1
    return launch


class Tiny(torch.nn.Module):
    """(B, D, H, W, 1) → deep-supervision logits at full and half size;
    `launch` is called once a forward."""

    def __init__(self, seed=0, launch=None):
        super().__init__()
        torch.manual_seed(seed)
        self.lin = torch.nn.Linear(1, NCLS)
        self.launch = launch

    def forward(self, x):
        if self.launch is not None:
            self.launch()
        y = self.lin(x)
        return [y, y[:, ::2, ::2, ::2]]


def batch():
    g = torch.Generator().manual_seed(1)
    return (torch.randn(2, 4, 4, 4, 1, generator=g),
            torch.randint(0, NCLS, (2, 4, 4, 4), generator=g))


def one_step(n=1, launch=None):
    model = Tiny(launch=launch)
    step = make_train_step(model, make_sgd(model.parameters(), 0.1))
    image, label = batch()
    outs = [step(image, label) for _ in range(n)]
    return outs, [p.detach().clone() for p in model.parameters()]


def engine(tta_batch=8, launch=None):
    lin = torch.nn.Linear(1, NCLS)
    with torch.no_grad():
        lin.weight.copy_(torch.tensor([[1.0], [-2.0], [0.5]]))
        lin.bias.copy_(torch.tensor([0.1, 0.0, -0.3]))

    def apply_fn(x):
        if launch is not None:
            launch()
        return lin(x)
    return SlidingWindowInference(apply_fn, PATCH, NCLS, tta_batch=tta_batch, device="cpu")


def volume(seed=2):
    return np.random.default_rng(seed).standard_normal(VOLUME).astype(np.float32)


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def tree(records):
    """[(name, parent's name or None, unit)] in entry order."""
    return [(r.name, r.parent.name if r.parent else None, r.unit) for r in records]


def test_no_profiler_no_spans(monkeypatch):
    made = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", lambda **kw: made.append(kw))
    assert profiling.span("dlka.step", step=0) is profiling.span("x") is profiling._OFF
    one_step(2)
    engine().predict_segmentation(volume())
    assert profiling.spans() == [] and made == []


def test_step_spans_under_the_profiler():
    with cpu_profile() as prof:
        one_step(2)
    recs = profiling.spans()
    step0, step1 = recs[0], recs[6]
    assert tree(recs) == [("dlka.step", None, 0)] + [(n, "dlka.step", 0) for n in STEP_PHASES] \
        + [("dlka.step", None, 1)] + [(n, "dlka.step", 1) for n in STEP_PHASES]
    assert step0.args == {"step": 0} and step1.args == {"step": 1}
    assert [r.unit_span for r in recs] == ([True] + [False] * 5) * 2
    assert all(r.start is None and r.end is None for r in recs)
    names = {e.name for e in prof.events()}
    assert {"dlka.step", *STEP_PHASES} <= names


def window_tree(tiles, unit, per_tile=("dlka.window.flip", "dlka.window.forward",
                                       "dlka.window.tta")):
    w = "dlka.window"
    out = [(w, None, unit), (w + ".upload", w, unit)]
    for _ in range(tiles):
        out.append((w + ".tile", w, unit))
        out += [(n, w + ".tile", unit) for n in per_tile]
        out.append((w + ".blend", w + ".tile", unit))
    return out + [(w + ".normalize", w, unit), (w + ".argmax", w, unit),
                  (w + ".fetch", w, unit)]


def test_window_spans_under_the_profiler():
    sw = engine()
    with cpu_profile():
        sw.predict_segmentation(volume(2))
        sw.predict_segmentation(volume(3))
    recs = profiling.spans()
    tiles = len(sw.origins(VOLUME[:3]))
    assert tiles == 8
    assert tree(recs) == window_tree(tiles, 0) + window_tree(tiles, 1)
    assert recs[0].args == {"shape": VOLUME[:3], "tiles": tiles}
    assert [r.name for r in recs if r.unit_span] == ["dlka.window"] * 2


def test_window_spans_with_smaller_flip_batches_and_predict():
    sw = engine(tta_batch=2)
    with cpu_profile():
        sw.predict(volume())
    recs = profiling.spans()
    per_tile = ("dlka.window.flip", "dlka.window.forward", "dlka.window.tta") * 4
    want = window_tree(8, 0, per_tile)
    assert tree(recs) == [r for r in want if r[0] != "dlka.window.argmax"]


@pytest.mark.parametrize("tta_batch", [8, 4])
def test_counter_deltas_on_the_unit_spans(tta_batch, fake_launch):
    sw = engine(tta_batch, fake_launch)
    with cpu_profile():
        sw.predict_segmentation(volume())
        fake_launch()                   # between the volumes: in neither's deltas
        sw.predict(volume())
    seg, full = [r for r in profiling.spans() if r.unit_span]
    forwards = 8 * 8 // tta_batch       # 8 tiles, 8 flips in batches of tta_batch
    assert seg.launches == full.launches == {"deform_conv3d": forwards}
    assert all(r.launches is None for r in profiling.spans() if not r.unit_span)


def test_launches_untraced_leave_no_record(fake_launch):
    before = kernels.deform_conv3d.launches
    engine(launch=fake_launch).predict_segmentation(volume())
    assert kernels.deform_conv3d.launches - before == 8
    assert profiling.spans() == []


def test_step_unit_span_stores_counter_deltas(fake_launch):
    with cpu_profile():
        one_step(launch=fake_launch)
        fake_launch()                   # after the unit: not in its deltas
    step = profiling.spans()[0]
    assert step.unit_span and step.launches == {"deform_conv3d": 1}


def test_unit_spans_without_hand_kernels_store_no_launches():
    with cpu_profile():
        one_step()
        engine().predict_segmentation(volume())
    assert [r.launches for r in profiling.spans() if r.unit_span] == [{}, {}]


def test_chrome_trace_holds_the_tile_spans(tmp_path):
    sw = engine()
    with trace(tmp_path / "t") as log_dir:
        sw.predict_segmentation(volume())
    events = json.loads((log_dir / "trace.json").read_text())["traceEvents"]
    names = [e.get("name") for e in events]
    assert names.count("dlka.window.tile") == 8
    assert names.count("dlka.window") == 1


class FakeEvent:
    """A stand-in for `torch.cuda.Event`: `record` takes the host clock."""

    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.t = None

    def record(self):
        self.t = profiling.time.perf_counter_ns()

    def elapsed_time(self, end):
        return (end.t - self.t) / 1e6


def test_recording_span_records_two_events_and_never_syncs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: pytest.fail("synchronised"))
    FakeEvent.made = 0
    with cpu_profile():
        one_step()
    recs = profiling.spans()
    assert FakeEvent.made == 2 * len(recs) == 12
    step = recs[0]
    assert all(r.start.t is not None and r.end.t is not None for r in recs)
    assert sum(r.start.elapsed_time(r.end) for r in recs[1:]) <= step.start.elapsed_time(step.end)


def test_the_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "_records", deque(maxlen=4))
    with cpu_profile():
        one_step()
    assert [r.name for r in profiling.spans()] == STEP_PHASES[1:]


def test_step_is_bitwise_the_same_traced():
    plain_out, plain_params = one_step(2)
    with cpu_profile():
        traced_out, traced_params = one_step(2)
    assert profiling.spans()
    for a, b in zip(plain_out, traced_out):
        assert torch.equal(a["loss"], b["loss"]) and torch.equal(a["grad_norm"], b["grad_norm"])
    assert all(torch.equal(a, b) for a, b in zip(plain_params, traced_params))


def test_window_is_bitwise_the_same_traced():
    sw, vol = engine(), volume()
    plain = sw.predict(vol), sw.predict_segmentation(vol)
    with cpu_profile():
        traced = sw.predict(vol), sw.predict_segmentation(vol)
    assert profiling.spans()
    assert np.array_equal(plain[0], traced[0]) and np.array_equal(plain[1], traced[1])


def stand_in(name, start, end, cuda=True, annotation=False):
    """A stand-in for a profiler event (times in µs)."""
    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
                           is_user_annotation=annotation)


# A profiled volume: the host's spans, and on the device two kernels inside
# the spans' device-side annotations (the window's, a tile's, a forward's).
WINDOW_EVENTS = [
    stand_in("dlka.window", 0, 1000, cuda=False),
    stand_in("aten::conv3d", 100, 200, cuda=False),
    stand_in("dlka.window", 50, 900, annotation=True),
    stand_in("dlka.window.tile", 60, 500, annotation=True),
    stand_in("dlka.window.forward", 100, 400, annotation=True),
    stand_in("sm90_xmma_fprop", 100, 300),
    stand_in("elementwise_kernel", 600, 700),
]


@pytest.mark.parametrize("extra", [[], [stand_in("elementwise_kernel", 650, 750)]],
                         ids=["two_kernels", "overlapping_kernel"])
def test_device_profile_leaves_span_annotations_out(extra, monkeypatch):
    events = WINDOW_EVENTS + extra

    class Profile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return events

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    r = profiling.device_profile(lambda: None)
    kernel_events = [e for e in events if e.device_type.name == "CUDA" and not e.is_user_annotation]
    assert not any(n.startswith("dlka.") for n in r["by_name"])
    assert r["n_kernels"] == len(kernel_events)
    assert r["kernel_ms"] == pytest.approx(sum(e.time_range.end - e.time_range.start
                                               for e in kernel_events) / 1e3)
    assert r["device_busy_ms"] == pytest.approx((200 + (150 if extra else 100)) / 1e3)
    assert sum(r["by_class"].values()) == pytest.approx(r["kernel_ms"])
