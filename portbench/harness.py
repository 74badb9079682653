"""What every cell of the benchmark shares: finding a cell's files by the
names in `BENCHMARK.json`, the weights made on the device from the seed,
the measured window, and the result line.

A cell names a configuration and a traffic mix. The harness finds

- `configs/<config>.json`: the configuration as it is run (sizes,
  source, `assumed`), and `configs/<config>.py`: `build(cfg, device,
  **options)`, the program's model at those sizes;
- `reference/<config>.py`: the plain PyTorch reference, which also lists
  the names, shapes and initialisations of the model's state
  (`param_shapes`);
- `traffic/<traffic>.json`: the mix's parameters, among them `loop`,
  the general generator and closed loop in `loops/<loop>.py`;
- `limits/<workload>.json`: the limit of each number the cell compares;
- `metrics/<metric up to its first dot>.py`: the reader of a per-layer
  metric (`read(ctx)`).

So a later cell, mix or metric is a set of new files and entries.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import math
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent          # portbench/
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "deformablelka_tpu")


class Fatal(SystemExit):
    """Ends the run with no result line."""

    def __init__(self, msg: str):
        print(f"portbench: {msg}", file=sys.stderr, flush=True)
        super().__init__(2)


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def benchmark() -> dict:
    path = REPO / "BENCHMARK.json"
    if not path.exists():
        raise Fatal(f"{path.name} not found beside {ROOT.name}/")
    return load_json(path)


def find_workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise Fatal(f"no workload {name!r} in BENCHMARK.json")


def module(kind: str, name: str):
    """`portbench.<kind>.<name>`, by file."""
    if not (ROOT / kind / f"{name}.py").exists():
        raise Fatal(f"no {kind}/{name}.py")
    return importlib.import_module(f"portbench.{kind}.{name}")


def merged(base: dict, over: dict | None) -> dict:
    out = dict(base)
    out.update(over or {})
    return out


def now() -> float:
    return time.perf_counter()


@contextlib.contextmanager
def stage(stages: list, label: str, device):
    """Appends (label, seconds) of the block, ended by a synchronise on
    `device`, to `stages`."""
    t0 = now()
    yield
    sync(device)
    stages.append((label, now() - t0))


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 on or off for cuBLAS and cuDNN within the block: off for the
    reference, on for the control."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def make_state(shapes: dict, seed: int, device) -> dict:
    """The model's state from `seed`, made on `device` in two draws (one
    uniform, one normal) and cut into the tensors that `shapes` lists:
    name → (shape, ("uniform", bound) | ("normal", std) | ("const", v))."""
    g = torch.Generator(device=device).manual_seed(seed)
    n_u = sum(math.prod(s) for s, (k, _) in shapes.values() if k == "uniform")
    n_n = sum(math.prod(s) for s, (k, _) in shapes.values() if k == "normal")
    uni = torch.rand(n_u, generator=g, device=device).mul_(2).sub_(1)
    nor = torch.randn(n_n, generator=g, device=device)
    state, iu, i_n = {}, 0, 0
    for name, (shape, (kind, v)) in shapes.items():
        n = math.prod(shape)
        if kind == "uniform":
            t = uni[iu:iu + n].view(shape) * v
            iu += n
        elif kind == "normal":
            t = nor[i_n:i_n + n].view(shape) * v
            i_n += n
        else:
            t = torch.full(shape, float(v), device=device)
        state[name] = t
    return state


def loaded_forbidden() -> list:
    """Top-level names in `sys.modules` that the program may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap of norms, |‖prog‖ − ‖ref‖| over the larger of
    the reference leaf's norm and the median leaf's. `keep`: the leaves
    to judge (all by default)."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return max(abs(float(torch.linalg.vector_norm(prog[k].double())) - norms[k])
               / max(norms[k], med, 1e-30) for k in (keep if keep is not None else ref))
