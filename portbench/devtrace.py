"""The traced run's reading of the device: `torch.profiler` over a
stretch of whole units, reduced to what the per-layer readers need.

Busy time is the union of the device's operation intervals (kernels,
copies, fills); the idle share is the rest of the stretch's wall time.
Kernels are put in classes by name (`kernel_class`, the program's own
classes at the time the benchmark was defined, with the optimizer's
`multi_tensor_apply` kernels apart). Each idle gap is named by the
innermost host operation or span that was running at its middle.
"""

from __future__ import annotations

import re
import time
from collections import defaultdict

import numpy as np
import torch

HAND = (("deform_dw_bwd", "deform_dw_conv2d_bwd"), ("deform_bwd", "deform_conv3d_bwd"),
        ("deform_conv3d_kernel", "deform_conv3d"), ("dw_chain3d_kernel", "dw_chain3d"),
        ("deform_dw_conv2d_kernel", "deform_dw_conv2d"), ("dw_chain2d_kernel", "dw_chain2d"),
        ("dwconv3d_kernel", "dwconv3d"))
DENSE = ("conv", "cudnn", "xmma", "implicit", "gemm", "sm90", "cutlass", "wgrad", "dgrad")


def kernel_class(name: str) -> str:
    """"hand:<kernel>", "dense" (cuDNN / cuBLAS convolutions and GEMMs),
    "optimizer" (the foreach kernels of the clip and SGD) or
    "elementwise" (norms, softmax, activations, copies, fills, the rest)."""
    for key, kernel in HAND:
        if key in name:
            return f"hand:{kernel}"
    low = name.lower()
    if "multi_tensor_apply" in low:
        return "optimizer"
    if any(s in low for s in DENSE):
        return "dense"
    return "elementwise"


class Profile:
    """One profiled stretch: `window_s` of wall time, `busy_s` of device
    activity, seconds and launches by kernel name, and the idle gaps
    named by the host's work."""

    def __init__(self, window_s, busy_s, by_name, launches, gaps):
        self.window_s, self.busy_s = window_s, busy_s
        self.by_name, self.launches, self.gaps = by_name, launches, gaps

    def class_s(self, cls: str) -> float:
        return sum(s for n, s in self.by_name.items() if kernel_class(n) == cls)

    def launches_of(self, pattern: str) -> int:
        """Launches of the kernels whose name matches `pattern` (a regex)."""
        rx = re.compile(pattern)
        return sum(c for n, c in self.launches.items() if rx.search(n))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n[:160], s] for n, s in self.gaps[:top]]}


def record(run, device) -> Profile:
    """`run()` under the profiler, ended by a synchronise."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    dev, host = [], []
    by_name, launches = defaultdict(float), defaultdict(int)
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or e.name.startswith("portbench."):
                continue   # a host span mirrored on the device's timeline
            dev.append((s, t))
            by_name[e.name] += (t - s) / 1e6
            launches[e.name] += 1
        elif t > s:
            host.append((s, t, e.name))
    if not dev:
        raise RuntimeError("the profiler recorded no device activity")
    busy, gaps, end = 0.0, [], float("-inf")
    for s, t in sorted(dev):
        if s > end > float("-inf"):
            gaps.append((end, s))
        if t > end:
            busy += t - max(s, end)
            end = t
    return Profile(window_s, busy / 1e6, dict(by_name), dict(launches), _name_gaps(gaps, host))


def _name_gaps(gaps, host, longest: int = 2000) -> list:
    """[(host operation, seconds)] summed over the `longest` gaps, largest
    first: each gap goes to the shortest host event that spans its
    middle."""
    if not gaps:
        return []
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:longest]
    starts = np.array([h[0] for h in host], dtype=np.float64)
    ends = np.array([h[1] for h in host], dtype=np.float64)
    spans = ends - starts
    out = defaultdict(float)
    for s, t in gaps:
        mid = (s + t) / 2
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
        name = host[inside[np.argmin(spans[inside])]][2] if inside.size else "(no host op)"
        out[name] += (t - s) / 1e6
    return sorted(out.items(), key=lambda kv: -kv[1])
