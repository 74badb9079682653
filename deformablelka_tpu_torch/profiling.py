"""A device-time breakdown of one run on the card, shared by the main path,
the training path and the 2D path: `torch.profiler` records the run, and its CUDA
kernels are summed by name and by class (the hand kernels, cuDNN/cuBLAS,
the rest); `timed`, the host clock of each call of a function, which
the trainers' recorders wrap around their pieces; `cold_ms`, a call's
time on the card with the L2 cache flushed before it; and the program's
own spans (`span`, `spans`).

Spans. `span(name, unit=False, **args)` marks a stretch of the program.
It records only while a `torch.profiler` session records (the flag the
profiler sets, read once per span); otherwise it is one shared no-op
context. A recording span is a `record_function` range on the profiler's
host timeline, under which the kernels launched inside it hang, and a
`SpanRecord` in a bounded buffer (`spans()`): its name, its parent, the
index of its unit span and, on CUDA, two timing events recorded on the
current stream. A span never synchronises: read the events
(`elapsed_time`) after the profiled stretch has ended. A unit span
(`unit=True`: a training step, a volume through the sliding window)
stores at exit what every hand kernel's `.launches` added while it was
open, and what the program's counters (`count`) gained.

Spans inside a CUDA graph. While the training step captures its graphs
(`graph_spans`), a span opened by the code captured is a `GraphSpan`,
traced or not: its two timing events are recorded as nodes of the graph
(`external=True`), so that each replay records them again, and no host
range is opened. Each replay under a recording phase span files a
`SpanRecord` of every such span (`replayed`), in the unit and under the
parents the eager step would give it, with the graph's events. The
events hold the last replay's times: read after the profiled stretch,
as any span's, every record of one graph span reads the stretch's last
replay.

| span | opened by |
|---|---|
| `dlka.step` (unit) > `.forward`, `.loss`, `.backward`, `.clip`, `.update` | `training/train_step.make_train_step`'s step |
| `dlka.window` (unit) > `.upload`, `.tile` (> `.flip`, `.forward`, `.tta`, `.blend`), `.normalize`, `.argmax`, `.fetch` | `inference/sliding_window.SlidingWindowInference` |
| `dlka.swin.stage` > `dlka.swin.attention` (the latter also under a block's recompute) | `nn/swin3d.py` |
| `dlka.maxvit.attention`: a block's or grid's partition, attention and reverse | `models/maxvit.PartitionAttentionCl` |
| `dlka.lka2d`: the deformable LKA gate (two deform convs, the 1×1, the product) | `nn/lka2d.deformable_LKA` |

| counter | counted by |
|---|---|
| `dlka.swin.windows`: windows attended | `nn/swin3d.SwinBlock3D` |
| `dlka.maxvit.windows`: windows attended | `models/maxvit.PartitionAttentionCl` |
| `dlka.step.graphed`: steps served by replaying the step's CUDA graphs | `training/train_step.StepGraphs` |
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict, deque

import torch
import torch.autograd.profiler as _autograd_profiler

from deformablelka_tpu_torch.ops import kernels

SPAN_LIMIT = 1 << 16          # records kept; the oldest go first

_OFF = contextlib.nullcontext()
_records: deque = deque(maxlen=SPAN_LIMIT)
_open: list = []              # the recording spans open now, innermost last
_units = 0                    # unit spans opened since `reset_spans`
_counts: defaultdict = defaultdict(int)   # the program's counters (`count`)
_captured = None              # the `GraphSpan`s of the graph being captured (`graph_spans`)
_graph_open: list = []        # the `GraphSpan`s open now, innermost last


class SpanRecord:
    """One recorded span, and the context that records it. `unit_span`
    marks a unit span and `unit` is the index of the unit it lies in;
    `start` and `end` are CUDA timing events (None off CUDA); `launches`
    is set on a unit span at exit: {hand kernel wrapper: launches}, and
    `counts`: {counter: what it gained}."""

    __slots__ = ("name", "args", "unit_span", "parent", "unit", "start", "end",
                 "launches", "counts", "_range", "_before", "_counted")

    def __init__(self, name: str, unit_span: bool, args: dict):
        self.name, self.unit_span, self.args = name, unit_span, args
        self.parent = self.unit = self.start = self.end = self.launches = self.counts = None

    def __enter__(self):
        global _units
        self.parent = _open[-1] if _open else None
        if self.unit_span:
            self.unit, _units = _units, _units + 1
            self._before = kernels.launch_counts()
            self._counted = dict(_counts)
        elif self.parent is not None:
            self.unit = self.parent.unit
        self._range = torch.profiler.record_function(
            self.name, ", ".join(f"{k}={v}" for k, v in self.args.items()) or None)
        self._range.__enter__()
        if torch.cuda.is_initialized():
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        _records.append(self)
        _open.append(self)
        return self

    def __exit__(self, *exc):
        if self.end is not None:
            self.end.record()
        if self.unit_span:
            self.launches = {k: v - self._before.get(k, 0)
                             for k, v in kernels.launch_counts().items()
                             if v != self._before.get(k, 0)}
            self.counts = {k: v - self._counted.get(k, 0) for k, v in _counts.items()
                           if v != self._counted.get(k, 0)}
        _open.pop()
        self._range.__exit__(*exc)
        return False


class GraphSpan:
    """A span opened while a CUDA graph is captured (`graph_spans`): two
    timing events recorded as nodes of the graph, its name, args and the
    graph span it lies in (`parent`, None at the graph's top)."""

    __slots__ = ("name", "args", "parent", "start", "end")

    def __init__(self, name: str, args: dict):
        self.name, self.args, self.parent = name, args, None
        self.start = torch.cuda.Event(enable_timing=True, external=True)
        self.end = torch.cuda.Event(enable_timing=True, external=True)

    def __enter__(self):
        self.parent = _graph_open[-1] if _graph_open else None
        self.start.record()
        _captured.append(self)
        _graph_open.append(self)
        return self

    def __exit__(self, *exc):
        self.end.record()
        _graph_open.pop()
        return False


def span(name: str, unit: bool = False, **args):
    """A context manager marking `name` (a unit span if `unit`): a
    `GraphSpan` while a graph is captured, a recording span while a
    `torch.profiler` session records, else the shared no-op `_OFF`."""
    if _captured is not None:
        return GraphSpan(name, args)
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return SpanRecord(name, unit, args)


@contextlib.contextmanager
def graph_spans():
    """Inside, spans are `GraphSpan`s (the code runs under a CUDA graph's
    capture): yields the list they are filed in, in the order they
    opened."""
    global _captured
    outer, _captured = _captured, []
    try:
        yield _captured
    finally:
        _captured = outer


def replayed(captured: list) -> None:
    """Files a `SpanRecord` of each of a replayed graph's spans
    (`captured`, from `graph_spans`) with the graph's events, its top
    spans under the innermost recording span, which gives them their
    unit; nothing where none is open (no profiler records)."""
    if not _open:
        return
    top, made = _open[-1], {}
    for g in captured:
        rec = SpanRecord(g.name, False, g.args)
        rec.parent = made[id(g.parent)] if g.parent is not None else top
        rec.unit, rec.start, rec.end = top.unit, g.start, g.end
        made[id(g)] = rec
        _records.append(rec)


def count(name: str, n: int = 1) -> None:
    """Adds `n` to the program's counter `name`, traced or not."""
    _counts[name] += n


def counts() -> dict:
    """{counter: its count since the process started}."""
    return dict(_counts)


def spans() -> list:
    """The span records kept, in the order the spans were entered."""
    return list(_records)


def reset_spans() -> None:
    """Forgets the span records and restarts the unit index."""
    global _units
    _records.clear()
    _units = 0


def timed(fn, times: list):
    """`fn`, appending the host seconds of each call to `times`."""
    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        times.append(time.perf_counter() - t0)
        return out
    return wrapped


def kernel_class(name: str) -> str:
    for k in kernels.HAND_KERNELS.values():
        if any(part in name for part in k.device_names):
            return f"{k.name} (hand kernel)"
    low = name.lower()
    if any(s in low for s in ("conv", "cudnn", "xmma", "implicit", "gemm",
                              "sm90", "cutlass", "wgrad", "dgrad")):
        return "cuDNN/cuBLAS conv and GEMM"
    return "elementwise, norms, softmax, copies"


PROFILE_ATTEMPTS = 3
_FLUSH_FLOATS = 32 << 20   # 128 MB written before a cold call: the H100's L2 holds 50 MB
_flush = None


def cold_ms(fn, reps: int = 10) -> float:
    """Per call, the median over `reps` calls of `fn`, each timed alone with
    CUDA events after 128 MB are written on the card (the L2 cache
    flushed, as a training step finds a kernel's inputs), after one
    warm-up call."""
    global _flush
    if _flush is None:
        _flush = torch.empty(_FLUSH_FLOATS, device="cuda")
    fn()
    marks = []
    for _ in range(reps):
        _flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return float(sorted(s.elapsed_time(e) for s, e in marks)[reps // 2])



def device_profile(run) -> dict:
    """Run `run()` under `torch.profiler` on the card: wall time, the
    device's busy time (the union of its kernel intervals), and device time
    by kernel class and by kernel. The profiler now and then records no
    device activity for a run of a few short kernels; the run is then
    profiled again, up to `PROFILE_ATTEMPTS` times in all, and an error
    raised if none recorded any. `by_name`: device ms by kernel name, the
    whole run. The ranges that `record_function` (and so `span`) mirrors
    onto the device's timeline are user annotations, not kernels, and are
    left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        intervals, by_name = [], defaultdict(float)
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
                intervals.append((e.time_range.start, e.time_range.end))
                by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3
        if intervals:
            break
    else:
        raise RuntimeError(f"the profiler recorded no device activity in "
                           f"{PROFILE_ATTEMPTS} runs")
    busy, end = 0.0, -1.0
    for s, t in sorted(intervals):
        if t > end:
            busy += t - max(s, end)
            end = t
    by_class = defaultdict(float)
    for name, ms in by_name.items():
        by_class[kernel_class(name)] += ms
    return {"wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
            "kernel_ms": sum(by_name.values()), "n_kernels": len(intervals),
            "by_class": dict(by_class), "by_name": dict(by_name),
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:15]}


def print_profile(title: str, r: dict) -> None:
    print(f"{torch.cuda.get_device_name(0)}; {title}: wall {r['wall_ms']:.1f} ms "
          f"under the profiler, device busy {r['device_busy_ms']:.1f} ms "
          f"({r['device_busy_ms'] / r['wall_ms']:.3f} of wall), "
          f"{r['n_kernels']} kernels summing {r['kernel_ms']:.1f} ms")
    for cls, ms in sorted(r["by_class"].items(), key=lambda kv: -kv[1]):
        print(f"  {ms:10.2f} ms  {ms / r['kernel_ms']:.3f}  {cls}")
    print("top kernels:")
    for name, ms in r["top"]:
        print(f"  {ms:10.2f} ms  {name[:110]}")
