"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Needs one CUDA card (the kernels are built for sm_90a: H100/H200) and
nvcc. Imports nothing of JAX. Phases, one line each (or a few):

1. device and build: the card's name and power limit (nvidia-smi), then
   the build of csrc/*.cu and its time;
2. each hand kernel against its plain PyTorch version, at the four stage
   shapes of the main path with batch 8 (deform offsets uniform in
   ±2.5, so some corners fall outside the volume), TF32 off: max|err|
   against the stated tolerance, and the times of the kernel, the plain
   version and one PyTorch library call for the same function, from CUDA
   events, beside the card's bound for the work;
3. the whole model, small input: the CUDA model against the same model
   on the CPU (the path the CPU tests hold against the JAX package);
4. the main path: `dlka_former_synapse(num_classes=14, do_ds=False)` at
   full width from seed 0, with gamma set to 1 and the offset convs'
   weights drawn from a seed, so the gates shape the logits and the
   offsets vary per voxel and reach past ±1; `predict_segmentation` of a
   seeded 96×192×160 volume with patch 64×128×128, step 0.5, Gaussian
   blending, 8-flip mirror TTA in one batch and argmax on the device.
   It prints the wall time, the peak device memory, each kernel's launch
   count (must be 21 blocks × 8 tiles = 168) and the share of voxels
   whose label agrees with the same run through the plain versions.

Then one JSON line of the kernels' numbers and, last, the contract line
{"ok": true, "device": {...}}. Any failure exits nonzero before it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from deformablelka_tpu_torch import main_path
from deformablelka_tpu_torch.main_path import BLOCKS, PATCH, TILES, VOLUME
from deformablelka_tpu_torch.models.dlka_former import dlka_former_synapse
from deformablelka_tpu_torch.nn.blocks3d import DeformConvPack3d
from deformablelka_tpu_torch.ops import kernels
from deformablelka_tpu_torch.ops.convs import to_ncdhw
from deformablelka_tpu_torch.ops.deform3d import deform_conv3d as deform_plain
from deformablelka_tpu_torch.ops.lka import dw_chain3d as chain_plain

# (spatial size, channels, transformer blocks at that stage) on the main path
STAGES = ((32, 32, 6), (16, 64, 6), (8, 128, 6), (4, 256, 3))
BATCH = 8
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
REL_TOL = 1e-4              # max|kernel - plain| ≤ REL_TOL · max(1, max|plain|)
MIN_AGREEMENT = 0.999       # argmax share, kernels vs plain versions


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", flush=True)
    raise SystemExit(1)


def timed_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, flops: float) -> dict:
    """The least time for the work: bytes over the memory rate, or
    operations over the f32 rate, whichever is larger."""
    return {"bytes_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
            "ops_ms": flops / F32_FLOP_PER_S * 1e3}


def _bound(r) -> tuple:
    return (max(r["bytes_ms"], r["ops_ms"]),
            "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations")


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print("phase 1 device: nvidia-smi name, power.limit:", flush=True)
    print(smi.splitlines()[0], flush=True)
    print(f"phase 1 device: torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    t0 = time.perf_counter()
    kernels.library()
    print(f"phase 1 build: csrc/*.cu with nvcc for sm_90a and loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


def phase_kernels():
    """Each kernel against its plain version at the four stage shapes."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    rows = {"deform_conv3d": [], "dw_chain3d": []}
    for S, C, sites in STAGES:
        V = S ** 3
        x = torch.randn(BATCH, S, S, S, C, device=dev, generator=g)
        # deform conv
        off = (torch.rand(BATCH, S, S, S, 81, device=dev, generator=g) * 2 - 1) * 2.5
        w = torch.randn(3, 3, 3, C, C, device=dev, generator=g) / (27 * C) ** 0.5
        b = torch.randn(C, device=dev, generator=g) * 0.1
        ref = deform_plain(x, off, w, b)
        got = kernels.deform_conv3d(x, off, w, b)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        tol = REL_TOL * max(1.0, ref.abs().max().item())
        outside = (off.abs() > 1).float().mean().item()
        ms = timed_ms(lambda: kernels.deform_conv3d(x, off, w, b), 20)
        pms = timed_ms(lambda: deform_plain(x, off, w, b), 3, warmup=1)
        n_bytes = 4 * (BATCH * V * (C + 81 + C) + 27 * C * C + C)
        flops = BATCH * V * 27 * (2 * C * C + 16 * C)
        bnd = bound_ms(n_bytes, flops)
        bms, by = _bound(bnd)
        rows["deform_conv3d"].append(dict(S=S, C=C, sites=sites, err=err, tol=tol,
                                          ms=ms, plain_ms=pms, lib_ms=None, **bnd))
        print(f"phase 2 deform_conv3d B={BATCH} {S}^3 C={C}: max|err| {err:.3e} "
              f"(tol {tol:.3e}), |Δ|>1 share {outside:.3f}, kernel {ms:.4f} ms, "
              f"plain {pms:.4f} ms, bound {bms:.4f} ms ({by})", flush=True)
        if not err <= tol:
            fail(f"deform_conv3d disagrees with its plain version at {S}^3 C={C}")
        del off, ref, got
        # dw chain
        w5 = torch.randn(5, 5, 5, 1, C, device=dev, generator=g) / 125 ** 0.5
        b5 = torch.randn(C, device=dev, generator=g) * 0.1
        w7 = torch.randn(7, 7, 7, 1, C, device=dev, generator=g) / 343 ** 0.5
        b7 = torch.randn(C, device=dev, generator=g) * 0.1
        ref = chain_plain(x, w5, b5, w7, b7)
        got = kernels.dw_chain3d(x, w5, b5, w7, b7)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        tol = REL_TOL * max(1.0, ref.abs().max().item())
        ms = timed_ms(lambda: kernels.dw_chain3d(x, w5, b5, w7, b7), 20)
        pms = timed_ms(lambda: chain_plain(x, w5, b5, w7, b7), 10)
        # the library call: two depthwise F.conv3d on NCDHW tensors
        xn = to_ncdhw(x).contiguous()
        w5n, w7n = w5.permute(4, 3, 0, 1, 2).contiguous(), w7.permute(4, 3, 0, 1, 2).contiguous()
        lms = timed_ms(lambda: F.conv3d(F.conv3d(xn, w5n, b5, padding=2, groups=C),
                                        w7n, b7, padding=9, dilation=3, groups=C), 10)
        n_bytes = 4 * (2 * BATCH * V * C + (125 + 343 + 2) * C)
        flops = BATCH * V * C * 2 * (125 + 343)
        bnd = bound_ms(n_bytes, flops)
        bms, by = _bound(bnd)
        rows["dw_chain3d"].append(dict(S=S, C=C, sites=sites, err=err, tol=tol,
                                       ms=ms, plain_ms=pms, lib_ms=lms, **bnd))
        print(f"phase 2 dw_chain3d B={BATCH} {S}^3 C={C}: max|err| {err:.3e} "
              f"(tol {tol:.3e}), kernel {ms:.4f} ms, plain {pms:.4f} ms, "
              f"F.conv3d x2 {lms:.4f} ms, bound {bms:.4f} ms ({by})", flush=True)
        if not err <= tol:
            fail(f"dw_chain3d disagrees with its plain version at {S}^3 C={C}")
        del x, xn, ref, got
        torch.cuda.empty_cache()
    return rows


def phase_small_reference():
    """The CUDA model against the same model on the CPU, small input."""
    img = (16, 32, 32)
    models = {}
    for dev in ("cuda", "cpu"):
        models[dev] = dlka_former_synapse(14, do_ds=False, img_size=img, seed=0,
                                          device=dev)
        main_path.drive_gates(models[dev], seed=7)
    x = torch.from_numpy(np.random.RandomState(3).randn(2, *img, 1).astype(np.float32))
    with torch.no_grad():
        ref = models["cpu"](x)
        got = models["cuda"](x.cuda()).cpu()
    err = (got - ref).abs().max().item()
    tol = 1e-3 * max(1.0, ref.abs().max().item())
    print(f"phase 3 small input {img} B=2: CUDA model vs CPU model max|err| "
          f"{err:.3e} (tol {tol:.3e}), finite {bool(torch.isfinite(got).all())}",
          flush=True)
    if not (err <= tol and torch.isfinite(got).all()):
        fail("the CUDA model disagrees with the CPU model on a small input")


def phase_main_path():
    model, sw = main_path.build(seed=0)
    vol = main_path.volume(seed=0)
    offsets_seen = []

    def record(_m, _inp, out):
        offsets_seen.append((out.abs().max().item(), (out.abs() > 1).float().mean().item()))

    if len(sw.origins(VOLUME)) != TILES:
        fail(f"expected {TILES} tiles")
    with torch.no_grad():  # warm-up: one batch-8 forward
        model(torch.zeros(8, *PATCH, 1, device="cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    seg = sw.predict_segmentation(vol)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels.WRAPPERS}
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 4 main path: predict_segmentation {VOLUME} patch {PATCH}, "
          f"{TILES} tiles x 8 flips: {wall:.3f} s wall, peak device memory "
          f"{peak / 2**30:.3f} GiB, launches {launches}", flush=True)
    expected = BLOCKS * TILES
    for name, n in launches.items():
        if n != expected:
            fail(f"{name} launched {n} times on the main path, expected {expected}")
    if seg.shape != VOLUME or seg.dtype != np.uint8 or seg.max() >= 14:
        fail(f"bad segmentation {seg.shape} {seg.dtype}")

    hooks = [m.conv_offset.register_forward_hook(record)
             for m in model.modules() if isinstance(m, DeformConvPack3d)]
    with mock.patch.object(kernels, "deform_conv3d", deform_plain), \
            mock.patch.object(kernels, "dw_chain3d", chain_plain):
        t0 = time.perf_counter()
        seg_plain = sw.predict_segmentation(vol)
        torch.cuda.synchronize()
        wall_plain = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    agree = float((seg == seg_plain).mean())
    max_off = max(m for m, _ in offsets_seen)
    past_one = float(np.mean([s for _, s in offsets_seen]))
    print(f"phase 4 main path vs plain versions: label agreement {agree:.6f} "
          f"(min {MIN_AGREEMENT}), plain run {wall_plain:.3f} s; offsets max|Δ| "
          f"{max_off:.3f}, mean share |Δ|>1 {past_one:.4f}; classes in seg "
          f"{np.unique(seg).size}", flush=True)
    if agree < MIN_AGREEMENT:
        fail("the main path through the kernels disagrees with the plain versions")
    if max_off <= 1.0:
        fail("the offsets never reached past ±1")
    return launches, wall


def kernel_line(rows, launches):
    sources = {"deform_conv3d": ("deformablelka_tpu_torch/csrc/deform3d.cu",
                                 "deformablelka_tpu/ops/pallas/deform3d_kernel.py:1008"),
               "dw_chain3d": ("deformablelka_tpu_torch/csrc/dw_chain3d.cu",
                              "deformablelka_tpu/ops/pallas/lka_fused_kernel.py:240")}
    out = []
    for name, rs in rows.items():
        per_fwd = lambda key: sum(r["sites"] * r[key] for r in rs)
        bound, by = _bound({"bytes_ms": per_fwd("bytes_ms"),
                            "ops_ms": per_fwd("ops_ms")})
        out.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": max(r["err"] for r in rs),
            "ms": per_fwd("ms"), "plain_ms": per_fwd("plain_ms"),
            "bound_ms": bound, "bound_by": by,
            "library_ms": None if rs[0]["lib_ms"] is None else per_fwd("lib_ms"),
            "per": "one forward at batch 8: the 21 launches at the four stage shapes",
        })
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    phase_device()
    rows = phase_kernels()
    phase_small_reference()
    launches, _ = phase_main_path()
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(kernel_line(rows, launches)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
