"""Parameter and operation counts, traces and latency benchmarks.

Port of `deformablelka_tpu/utils/profiling.py` (upstream's fvcore FLOP
print-out, its CUDA-event latency harness and its unused profiler):

- `count_params(module)`: the parameters' elements (buffers, such as batch
  norm's running statistics, are not parameters, as JAX keeps them out of
  "params").
- `cost_analysis` / `flops_report`: the operations of one call. torch's
  `FlopCounterMode` counts the matrix products and convolutions that
  torch dispatches (two per multiply-add, as XLA counts them); it does not
  see the hand kernels, which run through ctypes. So each kernel wrapper
  of `ops.kernels` is wrapped for the call: its operations are added by the
  formulas of the card's bounds in `chip_smoke.py` (PERF.md §6), and what
  torch's counter saw inside a wrapper (the plain version's convs, where a
  CPU tensor takes it) is taken out again, so that a D-LKA model is
  counted the same on the card and on the CPU. The backward of a kernel is
  counted where its wrapper runs (`deform_conv3d_bwd`,
  `deform_dw_conv2d_bwd` on the card); on the CPU autograd differentiates
  the plain version, and torch's counter counts what it sees of that.
  torch has no counterpart of XLA's "bytes accessed" (the bytes of every
  operation's operands): in its place the report gives `gbytes_floor`, the
  bytes the call cannot avoid moving, its tensor arguments and the
  module's parameters read once and its outputs written once, and the
  arithmetic intensity against that floor.
- `trace(log_dir)`: a `torch.profiler` trace of the block, written as a
  Chrome trace (`trace.json`, readable in Perfetto or chrome://tracing).
- `latency_bench` and `latency_bench_scan`: mean ± std in ms of a call,
  on CUDA events on the card (host clock on the CPU).
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Callable
from unittest import mock

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from deformablelka_tpu_torch.ops import kernels


def count_params(module: torch.nn.Module) -> int:
    return int(sum(p.numel() for p in module.parameters()))


def _taps_inside(extent: int, K: int, dil: int) -> int:
    """Σ over the positions of one axis of the K taps (dilation `dil`,
    centred) that fall inside it."""
    return sum(0 <= z + (k - K // 2) * dil < extent for z in range(extent) for k in range(K))


def kernel_ops(name: str, args) -> int:
    """The operations of one call of hand kernel `name` on `args`, by the
    formulas of its bound on the card (chip_smoke.py, PERF.md §6)."""
    x = args[0]
    if name == "deform_conv3d":       # per voxel and tap: the 8-corner blend, the mix
        B, D, H, W, Ci = x.shape
        Co = args[2].shape[-1]
        return B * D * H * W * 27 * (2 * Ci * Co + 16 * Ci)
    if name == "deform_conv3d_bwd":
        B, D, H, W, Ci = x.shape
        Co = args[2].shape[-1]
        return B * D * H * W * 27 * (4 * Ci * Co + 48 * Ci + 48)
    if name == "dw_chain3d":          # dw5³ and dw7³, a multiply-add per tap
        return x.numel() * 2 * (125 + 343)
    if name == "dw_chain2d":
        return x.numel() * 2 * (25 + 49)
    if name == "deform_dw_conv2d":    # per tap: the 4-corner blend (7) and the weight (2)
        K = args[2].shape[0] * args[2].shape[1]
        return x.numel() * K * 9
    if name == "deform_dw_conv2d_bwd":
        B, H, W, C = x.shape
        K = args[2].shape[0] * args[2].shape[1]
        return B * H * W * K * (32 * C + 24)
    if name == "dwconv3d":            # a multiply-add per tap inside the volume, the bias
        B, D, H, W, C = x.shape
        K, dil = args[1].shape[0], args[3]
        taps = _taps_inside(D, K, dil) * _taps_inside(H, K, dil) * _taps_inside(W, K, dil)
        return B * C * (2 * taps + D * H * W)
    raise KeyError(name)


@contextlib.contextmanager
def _counted_kernels(counter: FlopCounterMode, tally: dict):
    """Within: each kernel wrapper of `ops.kernels` adds its operations to
    `tally["hand"]` and what torch's counter saw inside it to
    `tally["inside"]`."""
    def counting(name, fn):
        def wrapped(*args, **kwargs):
            before = counter.get_total_flops()
            out = fn(*args, **kwargs)
            tally["inside"] += counter.get_total_flops() - before
            tally["hand"] += kernel_ops(name, args)
            tally["calls"][name] = tally["calls"].get(name, 0) + 1
            return out
        return wrapped

    with contextlib.ExitStack() as stack:
        for fn in kernels.WRAPPERS:
            stack.enter_context(mock.patch.object(
                kernels, fn.__name__, counting(fn.__name__, getattr(kernels, fn.__name__))))
        yield


def _tensor_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    return 0


def cost_analysis(fn: Callable, *args, **kwargs) -> dict:
    """One call of fn(*args, **kwargs), counted: {"flops": all of them,
    "torch_flops": torch's counter's part outside the hand kernels,
    "hand_kernel_flops", "hand_kernel_calls": by wrapper, "bytes_floor"}."""
    tally = {"hand": 0, "inside": 0, "calls": {}}
    counter = FlopCounterMode(display=False)
    with counter, _counted_kernels(counter, tally):
        out = fn(*args, **kwargs)
    torch_flops = counter.get_total_flops() - tally["inside"]
    params = [p for a in (fn, *args) if isinstance(a, torch.nn.Module)
              for p in a.parameters()]
    n_bytes = _tensor_bytes(args) + _tensor_bytes(kwargs) + _tensor_bytes(out) + \
        _tensor_bytes(params)
    return {"flops": torch_flops + tally["hand"], "torch_flops": torch_flops,
            "hand_kernel_flops": tally["hand"], "hand_kernel_calls": tally["calls"],
            "bytes_floor": n_bytes}


def flops_report(fn: Callable, *args, name: str = "model", **kwargs) -> dict:
    """fvcore's FLOPs print-out: GFLOPs of one call (the hand kernels' on a
    line of their own), the bytes floor and the intensity against it."""
    ca = cost_analysis(fn, *args, **kwargs)
    report = {"name": name, "gflops": ca["flops"] / 1e9,
              "hand_kernel_gflops": ca["hand_kernel_flops"] / 1e9,
              "hand_kernel_calls": ca["hand_kernel_calls"],
              "gbytes_floor": ca["bytes_floor"] / 1e9,
              "arithmetic_intensity": (ca["flops"] / ca["bytes_floor"]
                                       if ca["bytes_floor"] else float("nan"))}
    print(f"{name}: {report['gflops']:.3f} GFLOPs, {report['gbytes_floor']:.3f} GB "
          f"moved at least, AI={report['arithmetic_intensity']:.1f}")
    print(f"{name}: of them {report['hand_kernel_gflops']:.3f} GFLOPs in the hand "
          f"kernels {report['hand_kernel_calls']}")
    return report


@contextlib.contextmanager
def trace(log_dir: str = "torch_trace"):
    """A `torch.profiler` trace of the block (host, and the card's kernels
    where one is present), written to `log_dir/trace.json`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def _on_cuda(args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)


class _Clock:
    """CUDA events around a window on the card, the host clock on the CPU."""

    def __init__(self, cuda: bool):
        self.cuda = cuda

    def start(self):
        if self.cuda:
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)
            self.a.record()
        else:
            self.t0 = time.perf_counter()

    def stop_ms(self) -> float:
        if self.cuda:
            self.b.record()
            self.b.synchronize()
            return self.a.elapsed_time(self.b)
        return (time.perf_counter() - self.t0) * 1e3


@torch.no_grad()
def latency_bench(fn: Callable, args: tuple, warmup: int = 50, reps: int = 1000,
                  inner: int = 10) -> dict:
    """Upstream's test_inference_speed.py:23-55: `warmup` calls, then
    reps // inner windows of `inner` calls each, every window timed on CUDA
    events (host clock on the CPU); mean ± std of the per-call ms over the
    windows."""
    clock = _Clock(_on_cuda(args))
    for _ in range(warmup):
        fn(*args)
    if clock.cuda:
        torch.cuda.synchronize()
    times = []
    n_win = max(1, reps // inner)
    for _ in range(n_win):
        clock.start()
        for _ in range(inner):
            fn(*args)
        times.append(clock.stop_ms() / inner)
    times = np.asarray(times)
    return {"mean_ms": float(times.mean()), "std_ms": float(times.std()),
            "reps": n_win * inner}


@torch.no_grad()
def latency_bench_scan(fn: Callable, args: tuple, reps: int = 100, rounds: int = 5) -> dict:
    """Device time per call: in each of `rounds` rounds, `reps` calls
    queued back to back between two CUDA events with no host sync between
    them (the host clock on the CPU), after one warm call; mean ± std of
    the per-call ms over the rounds. The JAX package scans `reps` forwards
    in one program; eager calls queue on the stream the same way as long
    as the host keeps ahead of the card."""
    clock = _Clock(_on_cuda(args))
    fn(*args)
    if clock.cuda:
        torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        clock.start()
        for _ in range(reps):
            fn(*args)
        times.append(clock.stop_ms() / reps)
    times = np.asarray(times)
    return {"mean_ms": float(times.mean()), "std_ms": float(times.std()),
            "reps": reps * rounds}
