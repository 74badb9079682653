"""Arguments, discovery by name, the result line, and a run with no card."""

import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench import devtrace, harness, run
from portbench.tests.conftest import INFER_SMALL, WITH_2D

REPO = Path(__file__).resolve().parents[2]


def test_arguments():
    a = run.parse(["--workload", "synapse3d.infer", "--seed", "3000000001",
                   "--seconds", "30", "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == ("synapse3d.infer", 3000000001, 30.0, 1)
    with pytest.raises(SystemExit):
        run.parse(["--workload", "x", "--seed", "1", "--seconds", "1", "--trace", "2"])


def test_every_cell_finds_its_files():
    bench = WITH_2D
    for cell in bench["workloads"]:
        _, _, traffic, limits, loop = run.prepare(cell["name"], 1, device="cpu", bench=bench)
        assert loop.ctx.cfg["name"] == cell["config"]
        assert traffic["loop"] and limits
    for m in bench["per_layer"]:
        assert callable(harness.module("metrics", m["name"].partition(".")[0]).read)


def test_a_run_with_no_card_fails_and_prints_nothing(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", "synapse3d.infer", "--seed", "1", "--seconds", "1"])
    assert e.value.code != 0
    assert capsys.readouterr().out == ""


def test_too_few_cards_fail(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", "synapse3d.infer", "--seed", "1", "--seconds", "1"])
    assert e.value.code != 0


def test_the_command_alone_fails_without_a_card(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    files, the command exits non-zero and prints no result."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "out"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "synapse3d.infer",
                        "--seed", "5", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_a_run_on_the_cpu_prints_the_result_line_last(capsys):
    r = run.main(["--workload", "synapse3d.infer", "--seed", "2", "--seconds", "0.1"],
                 device="cpu", overrides=INFER_SMALL)
    out = capsys.readouterr()
    last = json.loads(out.out.strip().splitlines()[-1])
    assert last == json.loads(json.dumps(r))
    assert list(last) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert last["correct"] is True and last["attempted"] >= 1 and last["failed"] == 0
    assert set(last["metrics"]) == {"volumes_per_s", "setup_s"}
    assert set(last["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert out.err.strip().splitlines()[-1].startswith("check label_gap ")


def _fake_profile():
    by_name = {"void deform_conv3d_kernel<4>(float const*)": 0.004,
               "deform_conv3d_kernel_sum_parts(float const*)": 0.001,
               "sm90_xmma_fprop_implicit_gemm": 0.010, "elementwise_kernel": 0.003,
               "multi_tensor_apply_kernel": 0.002}
    launches = {k: 2 for k in by_name}
    return devtrace.Profile(0.025, 0.020, by_name, launches, [("aten::copy_", 0.004)])


def test_readers_of_a_profile():
    counts = {"flops": 1e9, "kernels": {"deform_conv3d": {"calls": 1, "least_s": 1e-3}}}
    ctx = SimpleNamespace(profile=_fake_profile(), units=2, counts=counts,
                          plain={"window_s": 0.02, "work": 2})
    read = lambda name: harness.module("metrics", name).read(ctx)
    assert read("idle_share") == pytest.approx(20.0)
    assert read("mfu") == pytest.approx(100 * 2e9 / 0.02 / 67e12)
    assert read("dense_ms") == pytest.approx(5.0)
    assert read("elementwise_ms") == pytest.approx(1.5)
    assert read("optimizer_ms") == pytest.approx(1.0)
    # two launches of the main kernel, each 1 ms at least, over 5 ms
    assert read("deform_conv3d_roofline") == pytest.approx(40.0)
    assert read("dw_chain3d_roofline") is None       # no such kernel ran
    bd = ctx.profile.breakdown()
    assert bd["device_ops"][0][0] == "sm90_xmma_fprop_implicit_gemm"
    assert bd["idle_gaps"] == [["aten::copy_", 0.004]]


def test_a_new_config_mix_and_metric_are_files_only(tmp_path):
    """A copy of the benchmark, to which a configuration, a mix and a
    metric are added as new files and entries, finds and runs them with
    no file of it edited."""
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "out"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "dlka_former_synapse.json").read_text())
    cfg.update(name="dlka_former_small", img_size=[16, 32, 32])
    (pb / "configs" / "dlka_former_small.json").write_text(json.dumps(cfg))
    for kind in ("configs", "reference"):
        (pb / kind / "dlka_former_small.py").write_text(
            f"from portbench.{kind}.dlka_former_synapse import *  # noqa\\n"
            + ("from portbench.reference.dlka_former_synapse import is_param  # noqa\\n"
               if kind == "reference" else ""))
    mix = json.loads((pb / "traffic" / "infer3d.json").read_text())
    mix.update(volume=[16, 32, 32], pool=2)
    (pb / "traffic" / "one_tile.json").write_text(json.dumps(mix))
    (pb / "limits" / "small.one_tile.json").write_text(json.dumps({"label_gap": 1e-3}))
    (pb / "metrics" / "busy_ms.py").write_text(textwrap.dedent('''
        def read(ctx):
            return 1e3 * ctx.profile.busy_s / ctx.units
    '''))
    bench["configs"].append({"name": "dlka_former_small", "source": "https://arxiv.org/abs/2309.00121",
                             "file": "portbench/configs/dlka_former_small.json",
                             "reduced": ["img_size"], "why": "a test"})
    bench["workloads"].append({"name": "small.one_tile", "config": "dlka_former_small",
                               "traffic": "one_tile", "chips": 1, "why": "a test"})
    next(m for m in bench["end_to_end"] if m["name"] == "volumes_per_s")["workloads"].append(
        "small.one_tile")
    bench["per_layer"].append({"name": "busy_ms.infer3d", "unit": "ms/volume", "better": "lower",
                               "source": "device_trace", "layer": "device",
                               "moves": "volumes_per_s", "workloads": ["small.one_tile"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "deformablelka_tpu_torch").symlink_to(REPO / "deformablelka_tpu_torch")
    script = textwrap.dedent('''
        import json, sys
        from types import SimpleNamespace
        sys.path.insert(0, ".")
        from portbench import devtrace, run
        r = run.main(["--workload", "small.one_tile", "--seed", "9", "--seconds", "0.1"],
                     device="cpu")
        assert r["correct"] and set(r["metrics"]) == {"volumes_per_s", "setup_s"}, r
        bench, cell, _, _, loop = run.prepare("small.one_tile", 9, device="cpu")
        prof = devtrace.Profile(2.0, 1.0, {"k": 1.0}, {"k": 1}, [])
        out = run._per_layer(bench, cell, loop, prof, 4, {"window_s": 1.0, "work": 4})
        assert out["busy_ms.infer3d"]["value"] == 250.0, out
        assert set(out) == {"busy_ms.infer3d"}, out
        print("ok")
    ''')
    p = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "ok"
