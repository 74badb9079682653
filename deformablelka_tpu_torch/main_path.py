"""The port's main path, and a device-time breakdown of it.

The main path is the JAX package's bench protocol (`bench.py:132-223`):
`dlka_former_synapse(num_classes=14, do_ds=False)` behind
`SlidingWindowInference` on a 96×192×160 volume, patch 64×128×128, step
0.5 (8 tiles), Gaussian blending, the 8 mirror flips in one batch, argmax
on the device. Weights are random from a seed; `build` then sets every
gamma to 1 and draws the offset convs' weights from the seed, so that the
D-LKA gates shape the logits and the offsets vary per voxel and reach
past ±1 (at init the offset weights are zero and gamma is 1e-6).

    python -m deformablelka_tpu_torch.main_path

runs the main path once to warm up, then once under `torch.profiler` on
the card, and prints the wall time, the device's busy share (the union of
its kernel intervals over the wall time) and the device time by kernel
class and by kernel.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch

from deformablelka_tpu_torch.inference.sliding_window import SlidingWindowInference
from deformablelka_tpu_torch.models.dlka_former import dlka_former_synapse
from deformablelka_tpu_torch.nn.blocks3d import DeformConvPack3d

PATCH = (64, 128, 128)
VOLUME = (96, 192, 160)
NUM_CLASSES = 14
TILES = 8
BLOCKS = 21  # D-LKA blocks in one forward: one launch of each kernel apiece


def drive_gates(model, seed: int) -> None:
    """gamma 1; offset-conv weights N(0, (10/sqrt(27·C))²) from `seed`."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, DeformConvPack3d):
                C = m.weight.shape[1]
                w = torch.randn(m.conv_offset.weight.shape, generator=g)
                m.conv_offset.weight.copy_(w * 10.0 / (27 * C) ** 0.5)
            if hasattr(m, "gamma"):
                m.gamma.fill_(1.0)


def build(seed: int = 0, device="cuda"):
    """The model (gates driven) and the sliding-window engine."""
    model = dlka_former_synapse(NUM_CLASSES, do_ds=False, seed=seed,
                                device=device)
    drive_gates(model, seed + 11)
    sw = SlidingWindowInference(model, patch_size=PATCH,
                                num_classes=NUM_CLASSES, step_size=0.5,
                                do_mirroring=True, tta_batch=8, device=device)
    return model, sw


def volume(seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randn(*VOLUME, 1).astype(np.float32)


def kernel_class(name: str) -> str:
    if "deform_conv3d_kernel" in name:
        return "deform_conv3d (hand kernel)"
    if "dw_chain3d_kernel" in name:
        return "dw_chain3d (hand kernel)"
    low = name.lower()
    if any(s in low for s in ("conv", "cudnn", "xmma", "implicit", "gemm",
                              "sm90", "cutlass", "wgrad", "dgrad")):
        return "cuDNN/cuBLAS conv and GEMM"
    return "elementwise, norms, softmax, copies"


def profile_main_path(seed: int = 0) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, sw = build(seed)
    vol = volume(seed)
    sw.predict_segmentation(vol)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sw.predict_segmentation(vol)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    if not spans:
        raise RuntimeError("the profiler recorded no device activity")
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
            "by_class": dict(by_class),
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:15]}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    r = profile_main_path()
    print(f"{torch.cuda.get_device_name(0)}; main path {VOLUME}, {TILES} tiles "
          f"x 8 flips: wall {r['wall_ms']:.1f} ms under the profiler, device "
          f"busy {r['device_busy_ms']:.1f} ms ({r['device_busy_ms'] / r['wall_ms']:.3f}"
          f" of wall), {r['n_kernels']} kernels summing {r['kernel_ms']:.1f} ms")
    for cls, ms in sorted(r["by_class"].items(), key=lambda kv: -kv[1]):
        print(f"  {ms:10.2f} ms  {ms / r['kernel_ms']:.3f}  {cls}")
    print("top kernels:")
    for name, ms in r["top"]:
        print(f"  {ms:10.2f} ms  {name[:110]}")


if __name__ == "__main__":
    main()
