"""The training step replayed as CUDA graphs (`train_step.StepGraphs`).

On the CPU (tier-1): the step never captures, `dlka.step.graphed` stays
0 and every call returns loss tensors of its own; the spans of a graph
(`profiling.graph_spans`, `GraphSpan`, `replayed`) through a stand-in
event class; and the reader of `graphed_steps.<f>` on synthetic span
records.

Marked `cuda` (each test skips without a card; on the card: `python -m
pytest tests/test_torch_graph_step.py -m cuda --noconftest`, since
`tests/conftest.py` imports JAX): a small D-LKA Former and a small Swin
UNETR stepped by replay against eager copies over 4 steps, the returned
losses distinct tensors, the launch and counter deltas of eager, capture
and replayed steps equal, the spans of a replayed step those of an eager
one, a new batch shape captured anew and a new learning rate replayed,
and the data-parallel step eager. Tolerance: where a gradient adds with atomics
(kernel 3's data gradient among others) two eager runs differ; the
graphs launch the same kernels, so a replayed run may differ from an
eager one by as much, taken as 4 × the largest gap among three eager
runs, plus 1e-6 of the quantity for runs that agree bitwise.
"""

from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deformablelka_tpu_torch import profiling
from deformablelka_tpu_torch.ops import kernels
from deformablelka_tpu_torch.training import train_step as ts
from deformablelka_tpu_torch.training.train_step import (
    GRAPHED, clip_grad_norm, loss_of, make_sgd, make_train_step)
from portbench import harness

torch.set_num_threads(1)
STEPS = 4


@pytest.fixture(autouse=True)
def fresh_spans():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def graphed() -> int:
    return profiling.counts().get(GRAPHED, 0)


class Tiny(torch.nn.Module):
    """(B, D, H, W, 1) → deep-supervision logits at full and half size."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.lin = torch.nn.Linear(1, 3)

    def forward(self, x):
        y = self.lin(x)
        return [y, y[:, ::2, ::2, ::2]]


def tiny_batch(seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(2, 4, 4, 4, 1, generator=g), torch.randint(0, 3, (2, 4, 4, 4), generator=g)


# --- the CPU ---------------------------------------------------------------


def test_the_cpu_step_never_captures(monkeypatch):
    monkeypatch.setattr(ts, "StepGraphs", lambda *a: pytest.fail("captured on the CPU"))
    model = Tiny()
    step = make_train_step(model, make_sgd(model.parameters(), 0.1))
    before = graphed()
    assert GRAPHED in profiling.counts()
    image, label = tiny_batch()
    for _ in range(STEPS):
        step(image, label)
    assert graphed() == before


def test_the_cpu_step_returns_a_loss_of_its_own_each_call():
    model = Tiny()
    step = make_train_step(model, make_sgd(model.parameters(), 0.1))
    image, label = tiny_batch()
    outs = [step(image, label) for _ in range(STEPS)]
    values = [float(o["loss"]) for o in outs]
    assert len({id(o["loss"]) for o in outs}) == STEPS
    assert len({o["loss"].data_ptr() for o in outs}) == STEPS
    assert [float(o["loss"]) for o in outs] == values and len(set(values)) == STEPS


class StandInEvent:
    """A stand-in for `torch.cuda.Event`: `record` takes the host clock."""

    def __init__(self, enable_timing=False, external=False):
        assert enable_timing and external
        self.t = None

    def record(self):
        self.t = profiling.time.perf_counter_ns()

    def elapsed_time(self, end):
        return (end.t - self.t) / 1e6


def _capture_like_a_step():
    """The spans of a forward as a graph captures them: a stage holding
    two attentions, then a second stage."""
    with profiling.graph_spans() as captured:
        with profiling.span("dlka.swin.stage", stage=0):
            for _ in range(2):
                with profiling.span("dlka.swin.attention"):
                    pass
        with profiling.span("dlka.swin.stage", stage=1):
            pass
    return captured


def test_spans_under_a_capture_are_graph_spans_traced_or_not(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", StandInEvent)
    captured = _capture_like_a_step()
    assert profiling.span("x") is profiling._OFF
    assert [type(g) for g in captured] == [profiling.GraphSpan] * 4
    assert [g.name for g in captured] == ["dlka.swin.stage", "dlka.swin.attention",
                                          "dlka.swin.attention", "dlka.swin.stage"]
    assert [None if g.parent is None else g.parent.name for g in captured] == [
        None, "dlka.swin.stage", "dlka.swin.stage", None]
    assert all(g.start.t is not None and g.end.t is not None for g in captured)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.graph_spans() as inner:
            with profiling.span("dlka.step.loss"):
                pass
    assert profiling.spans() == [] and [g.name for g in inner] == ["dlka.step.loss"]


def test_a_replay_files_the_graph_spans_in_its_unit(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", StandInEvent)
    captured = _capture_like_a_step()
    profiling.replayed(captured)               # nothing records: nothing filed
    assert profiling.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(2):
            with profiling.span("dlka.step", unit=True, step=k):
                with profiling.span("dlka.step.forward"):
                    profiling.replayed(captured)
    recs = profiling.spans()
    tree = [(r.name, r.parent.name, r.unit) for r in recs if not r.unit_span]
    one = [("dlka.step.forward", "dlka.step"), ("dlka.swin.stage", "dlka.step.forward"),
           ("dlka.swin.attention", "dlka.swin.stage"), ("dlka.swin.attention", "dlka.swin.stage"),
           ("dlka.swin.stage", "dlka.step.forward")]
    assert tree == [(n, p, 0) for n, p in one] + [(n, p, 1) for n, p in one]
    filed = [r for r in recs if r.name.startswith("dlka.swin")]
    assert [(r.start, r.end) for r in filed] == [(g.start, g.end) for g in captured] * 2
    assert [r.args for r in filed[:4]] == [{"stage": 0}, {}, {}, {"stage": 1}]


def _unit(graphed_n, counted=True):
    return SimpleNamespace(name="dlka.step", unit_span=True, launches={},
                           counts={GRAPHED: graphed_n} if counted and graphed_n else
                           ({} if counted else None))


def _read_graphed(records, monkeypatch, counters=True):
    monkeypatch.setattr(profiling, "spans", lambda: records)
    if not counters:
        monkeypatch.setattr(profiling, "counts", lambda: {"dlka.swin.windows": 3})
    return harness.module("metrics", "graphed_steps").read(SimpleNamespace(units=len(records)))


@pytest.mark.parametrize("replayed,want", [((1, 1), 100.0), ((0, 1), 50.0), ((0, 0), 0.0)])
def test_the_graphed_steps_reader_gives_the_share_replayed(replayed, want, monkeypatch):
    profiling.count(GRAPHED, 0)
    assert _read_graphed([_unit(n) for n in replayed], monkeypatch) == pytest.approx(want)


def test_the_graphed_steps_reader_gives_none_without_the_counter(monkeypatch):
    profiling.count(GRAPHED, 0)
    assert _read_graphed([], monkeypatch) is None
    assert _read_graphed([_unit(1, counted=False)], monkeypatch) is None
    assert _read_graphed([_unit(1)], monkeypatch, counters=False) is None   # a program without it
    monkeypatch.delattr(profiling, "counts")
    assert _read_graphed([_unit(1)], monkeypatch) is None


# --- the card ----------------------------------------------------------------


def former(seed=0):
    from deformablelka_tpu_torch import train_path

    path = train_path.build(seed=seed, img_size=(16, 32, 32))
    batches = [train_path.batch(seed + 100 + k, (16, 32, 32)) for k in range(STEPS)]
    return path.model, batches


def swin(seed=0):
    from deformablelka_tpu_torch.models.swin_unetr import swin_unetr_btcv

    model = swin_unetr_btcv(3, img_size=(32, 32, 32), feature_size=12, remat=True, seed=seed)
    g = torch.Generator().manual_seed(seed + 100)
    batches = [(torch.randn(2, 32, 32, 32, 1, generator=g).cuda(),
                torch.randint(0, 3, (2, 32, 32, 32), generator=g).cuda()) for _ in range(STEPS)]
    return model, batches


BUILD = {"former": former, "swin": swin}


def eager_step(model, opt):
    """The step's sequence without graphs."""
    params = [p for g in opt.param_groups for p in g["params"]]

    def step(image, label):
        opt.zero_grad()
        loss = loss_of(model, image, label)
        loss.backward()
        norm = clip_grad_norm(params)
        opt.step()
        return {"loss": loss.detach(), "grad_norm": norm}
    return step


def parameters(model) -> torch.Tensor:
    return torch.cat([p.detach().flatten() for p in model.parameters()])


def run(model, batches, step_of, lrs=(1e-2,) * STEPS):
    """(losses, grad norms, parameters) after a step a batch, each with
    its learning rate."""
    opt = make_sgd(model.parameters(), lrs[0])
    step = step_of(model, opt)
    outs = []
    for (image, label), lr in zip(batches, lrs):
        for g in opt.param_groups:
            g["lr"] = lr
        outs.append(step(image, label))
    return (torch.stack([o["loss"] for o in outs]), torch.stack([o["grad_norm"] for o in outs]),
            parameters(model))


def assert_within_eager_gap(got, eager, start):
    """`got` and each of `eager`: (losses, grad norms, parameters); the
    parameters compared by their change from `start`."""
    for i, what in enumerate(("loss", "grad_norm", "parameters")):
        runs, x = [r[i] for r in eager], got[i]
        if what == "parameters":
            runs, x = [r - start for r in runs], x - start
        gap = max(float((a - b).norm()) for a in runs for b in runs)
        off = float((x - runs[0]).norm())
        assert off <= 4 * gap + 1e-6 * float(runs[0].norm()), (what, off, gap)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["former", "swin"])
def test_the_graphed_step_follows_the_eager_step(cuda, name):
    build = BUILD[name]
    start = parameters(build()[0])
    eager = [run(*build(), eager_step) for _ in range(3)]
    before = graphed()
    got = run(*build(), make_train_step)
    assert graphed() - before == STEPS - 1          # the first call runs eagerly
    assert_within_eager_gap(got, eager, start)


@pytest.mark.cuda
def test_replayed_losses_are_tensors_of_their_own(cuda):
    model, batches = former()
    step = make_train_step(model, make_sgd(model.parameters(), 1e-2))
    outs, values = [], []
    for image, label in batches:
        outs.append(step(image, label))
        values.append((float(outs[-1]["loss"]), float(outs[-1]["grad_norm"])))
    assert len({o["loss"].data_ptr() for o in outs}) == STEPS
    assert len({o["grad_norm"].data_ptr() for o in outs}) == STEPS
    assert [(float(o["loss"]), float(o["grad_norm"])) for o in outs] == values


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["former", "swin"])
def test_eager_capture_and_replay_count_the_same(cuda, name):
    """The hand kernels' launches and the counters gained by each call are
    the same whether it ran eagerly, captured or replayed; traced, the
    unit spans store them, and each step files the same spans, each with
    a device stretch."""
    model, batches = BUILD[name]()
    step = make_train_step(model, make_sgd(model.parameters(), 1e-2))
    gained = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for image, label in batches:
            launches = kernels.launch_counts()
            counted = {k: v for k, v in profiling.counts().items() if k != GRAPHED}
            step(image, label)
            gained.append(({k: v - launches.get(k, 0) for k, v in kernels.launch_counts().items()
                            if v != launches.get(k, 0)},
                           {k: v - counted.get(k, 0) for k, v in profiling.counts().items()
                            if k != GRAPHED and v != counted.get(k, 0)}))
    torch.cuda.synchronize()
    assert all(g == gained[0] for g in gained)
    if name == "former":
        assert gained[0][0]["deform_conv3d_bwd"] > 0
    else:
        assert gained[0][1]["dlka.swin.windows"] > 0
    recs = profiling.spans()
    units = [r for r in recs if r.unit_span]
    assert len(units) == STEPS
    assert [r.launches for r in units] == [gained[0][0]] * STEPS
    assert [r.counts.get(GRAPHED, 0) for r in units] == [0, 1, 1, 1]
    trees = [[(r.name, r.parent.name) for r in recs if r.unit == u and not r.unit_span]
             for u in range(STEPS)]
    assert all(t == trees[0] for t in trees)
    assert all(r.start.elapsed_time(r.end) > 0 for r in recs)


@pytest.mark.cuda
@pytest.mark.parametrize("change", ["shape", "lr"])
def test_a_new_shape_or_learning_rate_is_captured_anew(cuda, change):
    """Two steps, then two with a new batch shape or a new learning rate.
    The first call on each shape runs eagerly; a new learning rate is no
    new key (the graphs read it from the card), so every step after the
    first replays. Either way the steps follow the eager step with the
    new batch or learning rate (a graph that kept the old one would
    not)."""
    lrs = (1e-2, 1e-2, 5e-3, 5e-3) if change == "lr" else (1e-2,) * STEPS

    def build():
        model, batches = swin()
        if change == "shape":
            batches = batches[:2] + [(x[:1], y[:1]) for x, y in batches[2:]]
        return model, batches

    start = parameters(build()[0])
    before = graphed()
    got = run(*build(), make_train_step, lrs)
    assert graphed() - before == (3 if change == "lr" else 2)   # calls 2-4, or 2 and 4
    assert_within_eager_gap(got, [run(*build(), eager_step, lrs) for _ in range(3)], start)


@pytest.mark.cuda
def test_the_data_parallel_step_stays_eager(cuda, tmp_path, monkeypatch):
    import torch.distributed as dist

    from deformablelka_tpu_torch import parallel

    monkeypatch.setattr(ts, "StepGraphs", lambda *a: pytest.fail("captured with a mesh"))
    parallel.init_process_group("cuda", f"file://{tmp_path / 'store'}", 0, 1)
    try:
        mesh = parallel.make_mesh(("data",), device_type="cuda")
        model, batches = swin()
        step = make_train_step(model, make_sgd(model.parameters(), 1e-2), mesh=mesh)
        before = graphed()
        for image, label in batches[:3]:
            assert torch.isfinite(step(image, label)["loss"])
        assert graphed() == before
    finally:
        dist.destroy_process_group()
