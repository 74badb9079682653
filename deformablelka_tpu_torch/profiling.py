"""A device-time breakdown of one run on the card, shared by the main path,
the training path and the 2D path: `torch.profiler` records the run, and its CUDA
kernels are summed by name and by class (the hand kernels, cuDNN/cuBLAS,
the rest); `timed`, the host clock of each call of a function, which
the trainers' recorders wrap around their pieces; and `cold_ms`, a call's
time on the card with the L2 cache flushed before it.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch


def timed(fn, times: list):
    """`fn`, appending the host seconds of each call to `times`."""
    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        times.append(time.perf_counter() - t0)
        return out
    return wrapped


def kernel_class(name: str) -> str:
    if "deform_dw_bwd" in name:
        return "deform_dw_conv2d_bwd (hand kernel)"
    if "deform_bwd" in name:
        return "deform_conv3d_bwd (hand kernel)"
    if "deform_conv3d_kernel" in name:
        return "deform_conv3d (hand kernel)"
    if "dw_chain3d_kernel" in name:
        return "dw_chain3d (hand kernel)"
    if "deform_dw_conv2d_kernel" in name:
        return "deform_dw_conv2d (hand kernel)"
    if "dw_chain2d_kernel" in name:
        return "dw_chain2d (hand kernel)"
    if "dwconv3d_kernel" in name:
        return "dwconv3d (hand kernel)"
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
    whole run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        spans, by_name = [], defaultdict(float)
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                spans.append((e.time_range.start, e.time_range.end))
                by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3
        if spans:
            break
    else:
        raise RuntimeError(f"the profiler recorded no device activity in "
                           f"{PROFILE_ATTEMPTS} runs")
    busy, end = 0.0, -1.0
    for s, t in sorted(spans):
        if t > end:
            busy += t - max(s, end)
            end = t
    by_class = defaultdict(float)
    for name, ms in by_name.items():
        by_class[kernel_class(name)] += ms
    return {"wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
            "kernel_ms": sum(by_name.values()), "n_kernels": len(spans),
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
