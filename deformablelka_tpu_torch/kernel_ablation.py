"""Chip ablation of a hand kernel: variants with one part removed, timed.

    python -m deformablelka_tpu_torch.kernel_ablation [--kernels deform3d_bwd,deform2d_dw]
        [--json PATH]

Each variant is the kernel's source in `deformablelka_tpu_torch/csrc/`
with a few text edits (`VARIANTS`: each edit must match the source
exactly once) and, optionally, another launch plan (`PLANS`), compiled
alone by its own nvcc process for sm_90a (all started together) into a
shared library and loaded with ctypes. Every variant is timed at the kernel's site shapes
(CUDA events over back-to-back calls, each call zeroing what the kernel
accumulates into, as the wrapper does), in turns with the full kernel; the
full kernel is first held against its plain version. A variant computes
something else: its time says what the removed part costs. Needs one
CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from deformablelka_tpu_torch.ops import kernels
from deformablelka_tpu_torch.ops.deform2d import deform_dw_conv2d as deform2d_plain
from deformablelka_tpu_torch.ops.deform3d import deform_conv3d_backward

STAGES_3D = ((32, 32), (16, 64), (8, 128), (4, 256))   # training path, B=2
SITES_2D = ((14, 384), (28, 192), (56, 96))            # 2D decoder, B=24
DEFORM_SITES_2D = ((5, 1), (7, 3))
REPS = 20
WINDOWS = 3

# kernel → [(variant, [(old text, new text), ...])]
VARIANTS = {
    "deform3d_bwd": [
        ("full", []),
        ("without the dx atomics", [(
            "          atomicAdd(reinterpret_cast<float4*>(dx + (size_t)id.x * Ci + cq),\n"
            "                    make_float4(wt * ds.x, wt * ds.y, wt * ds.z, wt * ds.w));\n",
            "")]),
        ("without the corner loads", [(
            "? __ldg(reinterpret_cast<const float4*>(x + (size_t)gi * Ci + cq))",
            "? make_float4((float)gi, 0.f, 0.f, 0.f)")]),
        ("without the dsamp mix (1 of 32 steps)", [(
            "#pragma unroll 8\n      for (int co = 0; co < kChunk; ++co) {",
            "#pragma unroll 8\n      for (int co = 0; co < 1; ++co) {")]),
        ("corner tables of the first tap only", [(
            "    if (tid < kRows) {\n      const int kz = k / 9",
            "    if (tid < kRows && k == k_begin) {\n      const int kz = k / 9")]),
        ("without the sample writes", [(
            "        if (vox >= 0 && has_q) {\n          *reinterpret_cast<float4*>(samp_k",
            "        if (vox >= 0 && has_q && sp.x == 12345.f) {\n"
            "          *reinterpret_cast<float4*>(samp_k")]),
        ("without the weight GEMM and its sum", [(
            "  float* out = parts > 1 ? part : dw;\n",
            "  return 0;\n  float* out = parts > 1 ? part : dw;\n")]),
        ("three blocks per SM (80 registers)", [(
            "__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 3)")]),
        ("a warp's voxel groups not unrolled", [(
            "#pragma unroll\n      for (int grp = 0;", "#pragma unroll 1\n      for (int grp = 0;")]),
        ("taps in groups of 3 more (fewer taps a block)", []),
        ("taps in groups of 3 fewer (more taps a block)", []),
        ("weight GEMM in half the parts", []),
        ("weight GEMM in twice the parts", []),
    ],
    "deform2d_dw": [
        ("full", []),
        ("without its corner loads", [
            (f"const float4 v{j} = __ldg(reinterpret_cast<const float4*>(xb + (size_t)q.{c} * C + c));",
             f"const float4 v{j} = make_float4((float)q.{c}, 0.f, 0.f, 0.f);")
            for j, c in enumerate("xyzw")]),
        ("without its weight reads", [(
            "const float4 wv = *reinterpret_cast<const float4*>(s_w + tap * kChunk + c - c0);",
            "const float4 wv = a;")]),
        ("no shared memory carveout preference", [(
            "    err = cudaFuncSetAttribute(deform_dw_conv2d_kernel<VEC>,\n"
            "                               cudaFuncAttributePreferredSharedMemoryCarveout, 50);",
            "    err = cudaSuccess;")]),
        ("shared memory carveout 25 %", [(
            "cudaFuncAttributePreferredSharedMemoryCarveout, 50);",
            "cudaFuncAttributePreferredSharedMemoryCarveout, 25);")]),
        ("tiles of 16 pixels", []),
    ],
}


# the kernel's own plan, kept before a variant stands in for it
_BWD_PLAN = kernels.deform3d_bwd_plan


def _replanned(plan, params: dict):
    """`plan` with some of its launcher parameters replaced (index → value)
    and its `parts` (parameter 13) kept in step."""
    values = list(plan.params)
    for i, v in params.items():
        values[i] = v
    return dataclasses.replace(plan, params=kernels._c_ints(*values), parts=values[13])


def _tap_groups(step: int):
    """deform3d_bwd_plan with its tap groups moved `step` places along 1, 3, 9, 27."""
    def plan(*shape):
        base = _BWD_PLAN(*shape)
        order = (1, 3, 9, 27)
        groups = order[min(3, max(0, order.index(list(base.params)[10]) + step))]
        return _replanned(base, {10: groups, 11: 27 // groups})
    return plan


def _gemm_parts(scale: float):
    """deform3d_bwd_plan with its weight GEMM cut into about `scale` × as
    many parts of whole 32-voxel steps."""
    def plan(*shape):
        base = _BWD_PLAN(*shape)
        B, D, H, W = shape[:4]
        n = B * D * H * W
        steps = -(-n // 32)
        parts = max(1, min(steps, round(base.parts * scale)))
        per_part = -(-steps // parts) * 32
        return _replanned(base, {13: -(-n // per_part), 14: per_part})
    return plan


_D2D_PLAN = kernels.deform2d_dw_plan


def _tiles_of_16(B, H, W, C, k, dil):
    """deform2d_dw_plan with tiles of 2 × 8 pixels."""
    base = _D2D_PLAN(B, H, W, C, k, dil)
    values = list(base.params)
    values[6], values[7], values[9] = 2, 8, k * k * (16 * 16 + 32 * 4)
    return dataclasses.replace(base, params=kernels._c_ints(*values))


# variant → (the plan function it replaces, the plan it runs with)
PLANS = {
    "taps in groups of 3 more (fewer taps a block)": ("deform3d_bwd_plan", _tap_groups(1)),
    "taps in groups of 3 fewer (more taps a block)": ("deform3d_bwd_plan", _tap_groups(-1)),
    "weight GEMM in half the parts": ("deform3d_bwd_plan", _gemm_parts(0.5)),
    "weight GEMM in twice the parts": ("deform3d_bwd_plan", _gemm_parts(2.0)),
    "tiles of 16 pixels": ("deform2d_dw_plan", _tiles_of_16),
}


def patched(source: str, edits) -> str:
    for old, new in edits:
        if source.count(old) != 1:
            raise ValueError(f"edit does not match exactly once: {old[:60]!r}")
        source = source.replace(old, new)
    return source


def build_variants(src: Path, variants, workdir: Path) -> dict:
    """Compile each variant of `src` into its own library, all at once. A
    variant whose edits no longer match the source is left out, and said so:
    remove it from `VARIANTS` rather than patch its text."""
    procs = {}
    text = src.read_text()
    for i, (name, edits) in enumerate(variants):
        try:
            source = patched(text, edits)
        except ValueError as err:
            print(f"ablation {src.name}: variant {name!r} left out, {err}", flush=True)
            continue
        cu = workdir / f"v{i}_{src.name}"
        cu.write_text(source)
        lib = workdir / f"v{i}_{src.stem}.so"
        procs[name] = (lib, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", str(cu), "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{out}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


class _Overlay:
    """The kernels' library with one source's symbols taken from a variant."""

    def __init__(self, variant, base):
        self._variant, self._base = variant, base

    def __getattr__(self, name):
        try:
            return getattr(self._variant, name)
        except AttributeError:
            return getattr(self._base, name)


def _bind_variant(lib, base):
    """Give a variant's launcher the argument types `library()`
    gives the real one."""
    for name in ("dlka_deform_conv3d_bwd", "dlka_deform_dw_conv2d"):
        if hasattr(lib, name):
            fn, ref = getattr(lib, name), getattr(base, name)
            fn.argtypes, fn.restype = ref.argtypes, ref.restype
    return _Overlay(lib, base)


def _variant(lib, base, wrapper, plan=None):
    overlay = _bind_variant(lib, base)

    def call(*args):
        saved = kernels._lib
        kernels._lib = overlay
        if plan is not None:
            saved_plan = getattr(kernels, plan[0])
            setattr(kernels, plan[0], plan[1])
        try:
            return wrapper(*args)
        finally:
            kernels._lib = saved
            if plan is not None:
                setattr(kernels, plan[0], saved_plan)
    return call


def _events_ms(fn, reps=REPS) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _close(got, ref) -> float:
    err = (got - ref).abs().max().item()
    if not err <= 1e-4 * max(1.0, ref.abs().max().item()):
        raise SystemExit(f"FAILED: the full kernel disagrees with its plain version "
                         f"(max|err| {err:.3e})")
    return err


def cases(kernel: str):
    """(label, inputs, plain reference) at the kernel's site shapes."""
    gen = torch.Generator(device="cuda").manual_seed(4321)
    if kernel == "deform3d_bwd":
        for S, C in STAGES_3D:
            x = torch.randn(2, S, S, S, C, device="cuda", generator=gen)
            off = (torch.rand(2, S, S, S, 81, device="cuda", generator=gen) * 2 - 1) * 2.5
            w = torch.randn(3, 3, 3, C, C, device="cuda", generator=gen) / (27 * C) ** 0.5
            g = torch.randn(2, S, S, S, C, device="cuda", generator=gen)
            yield f"B=2 {S}^3 C={C}", (x, off, w, g), lambda a=(x, off, w, g): \
                deform_conv3d_backward(*a)
    else:
        for S, C in SITES_2D:
            x = torch.randn(24, S, S, C, device="cuda", generator=gen)
            for k, dil in DEFORM_SITES_2D:
                off = (torch.rand(24, S, S, 2 * k * k, device="cuda", generator=gen) * 2
                       - 1) * 2.5
                w = torch.randn(k, k, 1, C, device="cuda", generator=gen) / k
                yield f"B=24 {S}^2 C={C} k={k} dil={dil}", (x, off, w, dil), \
                    lambda a=(x, off, w, dil): deform2d_plain(*a)


def ablate(kernel: str, workdir: Path) -> dict:
    src = kernels._PKG / "csrc" / {"deform3d_bwd": "deform3d_bwd.cu",
                                   "deform2d_dw": "deform2d_dw.cu"}[kernel]
    libs = build_variants(src, VARIANTS[kernel], workdir)
    wrapper = kernels.deform_conv3d_bwd if kernel == "deform3d_bwd" else \
        kernels.deform_dw_conv2d
    base = kernels.library()
    calls = {v: _variant(lib, base, wrapper, PLANS.get(v)) for v, lib in libs.items()}
    table = {}
    for label, args, plain in cases(kernel):
        got = calls["full"](*args)
        torch.cuda.synchronize()
        ref = plain()
        errs = [_close(a, r) for a, r in zip(got if isinstance(got, tuple) else (got,),
                                             ref if isinstance(ref, tuple) else (ref,))]
        del got, ref
        times = {v: [] for v in calls}
        for i in range(WINDOWS):
            order = list(calls) if i % 2 == 0 else list(calls)[::-1]
            for v in order:
                times[v].append(_events_ms(lambda: calls[v](*args)))
        row = {v: float(np.median(t)) for v, t in times.items()}
        table[label] = row
        full = row["full"]
        print(f"ablation {kernel} {label}: full {full:.4f} ms (max|err| vs "
              f"plain {max(errs):.3e}); " + "; ".join(
                  f"{v} {t:.4f} ms ({t - full:+.4f})" for v, t in row.items() if v != "full"),
              flush=True)
        torch.cuda.empty_cache()
    return table


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default="deform3d_bwd,deform2d_dw")
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ablation: needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(f"ablation device: {smi}", flush=True)
    out = {"device": smi}
    with tempfile.TemporaryDirectory() as tmp:
        for kernel in args.kernels.split(","):
            out[kernel] = ablate(kernel, Path(tmp))
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
