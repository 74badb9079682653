"""Readings that the limits of `limits/<workload>.json` are set from:
per seed, the numbers a cell compares for the program (its set-up and
`--units` units of its window), for the control (the plain reference
computed with TF32 on, in the program's place) and for each planted fault
(`faults.py`), each against the reference in float32. One process, so the
kernels' library and the first compile are paid once.

    python3 portbench/calibrate.py --workload <name> --seeds 1 2 ... \\
        [--control-seeds 1 2 3] [--faults half_batch ...] [--units 2]

Prints one JSON line per reading: {"seed", "side", "numbers", "seconds"}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import faults, run  # noqa: E402
from portbench.loops.train3d import SMALL_GRAD  # noqa: E402


def reading(workload, seed, units, fault=None, control=False, device=None, overrides=None,
            bench=None):
    t0 = time.perf_counter()
    _, _, _, _, loop = run.prepare(workload, seed, device, overrides, bench)
    with faults.FAULTS[fault]() if fault else contextlib.nullcontext():
        loop.setup()
        for _ in range(units):
            loop.run_unit()
    if loop.ctx.device == "cuda":
        torch.cuda.synchronize()
    got = loop.outputs()
    loop.release()
    ref = loop.reference()
    out = [("program" if fault is None else fault, loop.compare(got, ref))]
    if "grad1" in ref:   # the leaves a training cell's change leaves out
        norms = {k: float(v.norm()) for k, v in ref["grad1"].items()}
        med = sorted(norms.values())[len(norms) // 2]
        out.append(("left_out", {k: n / med for k, n in norms.items() if n < SMALL_GRAD * med}))
    if control:
        out.append(("control", loop.compare(loop.as_answer(loop.reference(tf32=True)), ref)))
    return out, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[], choices=sorted(faults.FAULTS))
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--units", type=int, default=1)
    args = ap.parse_args(argv)
    jobs = [(s, None, s in args.control_seeds) for s in args.seeds]
    jobs += [(s, f, False) for f in args.faults for s in args.fault_seeds]
    for seed, fault, control in jobs:
        rows, secs = reading(args.workload, seed, args.units, fault, control)
        for side, numbers in rows:
            print(json.dumps({"workload": args.workload, "seed": seed, "side": side,
                              "numbers": numbers, "seconds": secs}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
