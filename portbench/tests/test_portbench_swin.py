"""The Swin UNETR cell (`swin_unetr.train`) on the CPU at a small size,
the readers of its spans and counter on synthetic span records, and the
count of one Swin block on the reference against a hand count."""

import math
from types import SimpleNamespace

import pytest
import torch

from deformablelka_tpu_torch import profiling
from portbench import counts, harness, run
from portbench.reference import swin_unetr_btcv as R
from portbench.tests.test_portbench_spans import Event

SMALL = {"config": {"img_size": [32, 32, 32], "feature_size": 12},
         "traffic": {"pool": 2, "checked_steps": 2}}


def test_the_cell_runs_on_the_cpu_and_is_correct():
    r = run.main(["--workload", "swin_unetr.train", "--seed", "3000000123", "--seconds", "0.1"],
                 device="cpu", overrides=SMALL)
    assert r["correct"] is True
    assert set(r["metrics"]) == {"train_step_s", "setup_s"}
    assert set(r["checks"]) == {"loss_gap", "grad_gap", "update_gap"}


def _step(t, windows, counted=True):
    """A step of 100 ms: two stages of 10 ms, each with two attentions of
    3 ms, and `windows` counted on the unit span."""
    unit = SimpleNamespace(name="dlka.step", unit_span=True, start=Event(t), end=Event(t + 100),
                           launches={}, counts={"dlka.swin.windows": windows} if counted else None)
    out = [unit]
    for k in range(2):
        s = t + 20 * k
        out.append(SimpleNamespace(name="dlka.swin.stage", unit_span=False, start=Event(s),
                                   end=Event(s + 10)))
        out += [SimpleNamespace(name="dlka.swin.attention", unit_span=False,
                                start=Event(s + 3 * i), end=Event(s + 3 * i + 3)) for i in (0, 1)]
    return out


def _read(metric, records, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: records)
    return harness.module("metrics", metric).read(SimpleNamespace(units=2))


@pytest.mark.parametrize("metric,want", [("swin_ms", 20.0), ("window_attention_ms", 12.0),
                                         ("swin_windows", 3328.0)])
def test_swin_readers_give_their_number(metric, want, monkeypatch):
    assert _read(metric, _step(0, 3328) + _step(100, 3328), monkeypatch) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["swin_ms", "window_attention_ms", "swin_windows"])
def test_swin_readers_give_none_without_spans_or_counter(metric, monkeypatch):
    assert _read(metric, [], monkeypatch) is None
    if metric == "swin_windows":      # a program whose unit spans keep no counters
        assert _read(metric, _step(0, 0, counted=False), monkeypatch) is None
        assert _read(metric, _step(0, 0), monkeypatch) is None
    monkeypatch.delattr(profiling, "spans")
    assert harness.module("metrics", metric).read(SimpleNamespace(units=2)) is None


def test_one_swin_block_counted_by_hand():
    """A 7×7×14 map, window 7 (two windows of 343 tokens), C = 48 in 3
    heads: the linears 2·T·C²·(3 + 1 + 4 + 4) and each window's q·kᵀ and
    its product with v, 2 · 2·n²·C."""
    C, heads, size = 48, 3, (7, 7, 14)
    T, n = math.prod(size), 343
    p = {k: torch.empty(s, device="meta")
         for k, (s, _) in R._block_shapes("b", C, heads, 7).items()}
    x = torch.empty(1, *size, C, device="meta")
    c = counts.count_unit(lambda: R.block(p, "b", x, (7, 7, 7), (0, 0, 0), heads, 7))
    assert c["dense_flops"] == 2 * T * C * C * 12 + 2 * (4 * n * n * C)
    assert c["kernels"] == {}
