"""One run of one cell of the benchmark of `deformablelka_tpu_torch`.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

With `--trace 0`, set-up (imports, the kernels' library, weights and
inputs made on the card from the seed, warm-up of the cell's own shapes),
then a closed loop of the cell's units for `--seconds`, ended by a
synchronise: the last line carries the cell's end-to-end metrics. With
`--trace 1`, the same set-up, then the cell's `trace_units` twice: timed
alone (the rate `mfu` reads), then under `torch.profiler`: the last line
carries the per-layer metrics and a breakdown. Either way the program's outputs are then compared with the
plain reference, each number beside its limit on the last lines of
standard error and under "checks", the last key of the result line.

No card, fewer cards than the cell asks for, or JAX in the process:
no result line and a non-zero exit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _device_or_fail(chips: int) -> str:
    if not torch.cuda.is_available():
        raise harness.Fatal("no CUDA device: this benchmark measures the card")
    if torch.cuda.device_count() < chips:
        raise harness.Fatal(f"the cell asks for {chips} cards, "
                            f"{torch.cuda.device_count()} present")
    return "cuda"


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def _metric_names(bench, kind, workload):
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def prepare(workload: str, seed: int, device=None, overrides=None, bench=None):
    """(bench, cell, traffic, limits, loop) of one run of `workload` in
    `bench` (`BENCHMARK.json` by default); the card unless `device` names
    another."""
    bench = bench or harness.benchmark()
    cell = harness.find_workload(bench, workload)
    overrides = overrides or {}
    device = device or _device_or_fail(cell["chips"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device == "cuda":
        torch.set_num_threads(1)   # one host thread: the load of one process, steadier
    root = harness.ROOT
    cfg = harness.merged(harness.load_json(root / "configs" / f"{cell['config']}.json"),
                         overrides.get("config"))
    traffic = harness.merged(harness.load_json(root / "traffic" / f"{cell['traffic']}.json"),
                             overrides.get("traffic"))
    limits = harness.merged(harness.load_json(root / "limits" / f"{cell['name']}.json"),
                            overrides.get("limits"))
    ctx = SimpleNamespace(cfg=cfg, traffic=traffic, seed=seed, device=device, stages=[],
                          config=harness.module("configs", cell["config"]),
                          reference=harness.module("reference", cell["config"]))
    loop = harness.module("loops", traffic["loop"]).Loop(ctx)
    return bench, cell, traffic, limits, loop


def main(argv=None, device=None, overrides=None, bench=None) -> dict:
    """One run; returns the result it printed. `device`, `overrides`
    ({"config": {...}, "traffic": {...}, "limits": {...}}) and `bench` are
    for the CPU tests: a real run takes the card, the sizes and the cells
    as committed."""
    args = parse(argv)
    bench, cell, traffic, limits, loop = prepare(args.workload, args.seed, device,
                                                   overrides, bench)
    device = loop.ctx.device
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t_setup = harness.now()
    loop.setup()
    harness.sync(device)
    t0 = harness.now()
    setup_s = t0 - T_START
    stages = [("start and imports", t_setup - T_START)] + loop.ctx.stages
    stages.append(("inputs and warm-up", t0 - t_setup - sum(s for _, s in loop.ctx.stages)))
    units, profile, plain = 0, None, None
    if args.trace:
        from portbench import devtrace

        n = traffic["trace_units"]
        for _ in range(n):          # the same stretch untraced: the rate for `mfu`
            loop.run_unit()
        harness.sync(device)
        plain = {"window_s": harness.now() - t0, "work": _stretch(loop, n)["work"]}

        def stretch():
            nonlocal units
            for _ in range(n):
                with torch.profiler.record_function(f"portbench.{loop.unit}"):
                    loop.run_unit()
                units += 1

        profile = devtrace.record(stretch, device)
        window_s = profile.window_s
    else:
        while True:
            loop.run_unit()
            units += 1
            if harness.now() - t0 >= args.seconds:
                break
        harness.sync(device)
        window_s = harness.now() - t0
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    got = loop.outputs()
    loop.release()
    if device == "cuda":
        torch.cuda.empty_cache()
    numbers = loop.compare(got, loop.reference())
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    if args.trace:
        metrics = _per_layer(bench, cell, loop, profile, units, plain)
    else:
        e2e = loop.end_to_end(window_s, units)
        e2e["setup_s"] = setup_s
        metrics = {}
        for m in _metric_names(bench, "end_to_end", cell["name"]):
            if m["name"] not in e2e:
                raise harness.Fatal(f"the cell does not give {m['name']}")
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    if args.trace:
        dev.update(busy_s=profile.busy_s, window_s=profile.window_s)
        if device == "cuda":
            dev["power"] = _power_limit()
    result = {"correct": correct, "attempted": units, "failed": 0,
              "metrics": metrics, "device": dev}
    if args.trace:
        result["breakdown"] = profile.breakdown()
    result["checks"] = checks
    found = harness.loaded_forbidden()
    if found:
        raise harness.Fatal(f"the process holds {', '.join(found)}")
    print("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in stages), file=sys.stderr)
    if device == "cuda":
        print("launches: " + json.dumps(_launches()), file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return result


def _launches() -> dict:
    from deformablelka_tpu_torch.ops import kernels

    return {fn.__name__: fn.launches for fn in kernels.WRAPPERS}


def _stretch(loop, n: int) -> dict:
    """The per-layer units ("layer") and the units of work ("work") of the
    loop's last n units: both n, but where the loop says otherwise."""
    return getattr(loop, "stretch_units", lambda k: {"layer": k, "work": k})(n)


def _per_layer(bench, cell, loop, profile, units, plain) -> dict:
    counts = loop.count()
    n = _stretch(loop, units)
    out = {}
    for m in _metric_names(bench, "per_layer", cell["name"]):
        reader = harness.module("metrics", m["name"].partition(".")[0])
        ctx = SimpleNamespace(profile=profile, units=n["layer"], plain=plain, counts=counts)
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


if __name__ == "__main__":
    main()
