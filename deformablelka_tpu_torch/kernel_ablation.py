"""Chip ablation of a hand kernel: variants with one part removed, timed.

    python -m deformablelka_tpu_torch.kernel_ablation
        [--kernels deform3d_bwd,deform2d_dw,deform2d_dw_bwd] [--json PATH]
        [--reach R] [--integers F] [--cold] [--against DIR]

Each variant is the kernel's source in `deformablelka_tpu_torch/csrc/`
with a few text edits (`VARIANTS`: each edit must match the source
exactly once) and, optionally, another launch plan (`PLANS`), compiled
alone by its own nvcc process for sm_90a (all started together) into a
shared library and loaded with ctypes. Every variant is timed at the kernel's site shapes
(CUDA events over back-to-back calls, each call zeroing what the kernel
accumulates into, as the wrapper does), in turns with the full kernel; the
full kernel is first held against its plain version. A variant computes
something else: its time says what the removed part costs. `--cold`
times each call alone with the L2 cache flushed before it
(`profiling.cold_ms`), as a training step finds the kernel's inputs;
`--against DIR` adds, in the same turns, the kernel of another checkout
of the repository at DIR (its source, launch plan and wrapper, built into
DIR), for comparing two versions on one card in one run. Needs one CUDA
card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from deformablelka_tpu_torch.ops import kernels
from deformablelka_tpu_torch.ops.deform2d import deform_dw_conv2d as deform2d_plain
from deformablelka_tpu_torch.ops.deform2d import deform_dw_conv2d_backward as deform2d_bwd_plain
from deformablelka_tpu_torch.ops.deform3d import deform_conv3d_backward
from deformablelka_tpu_torch.profiling import cold_ms

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
        ("without the corner loads (window path)", [(
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
    "deform2d_dw_bwd": [
        ("full", []),
        ("one channel quad a lane (32-channel blocks)", []),
        ("two channel quads a lane (64-channel blocks)", []),
        ("one warp a tap row", []),
        ("two warps a tap row", []),
        ("without the tap loop (staging and dw parts only)", [(
            "  for (int jj = 0; jj < k; ++jj) {\n    const int tap = row * k + jj;",
            "  for (int jj = 0; jj < k * 0; ++jj) {\n    const int tap = row * k + jj;")]),
        ("without the items (staging, tables, dw parts only)", [(
            "      const int flags = e.y, p = e.y >> kPixelShift;",
            "      const int flags = e.y == 12345 ? e.y : 0, p = e.y >> kPixelShift;")]),
        ("without the sample arithmetic", [(
            "          const float top = fmaf(fx, e01, a00[j]), bot = fmaf(fx, e23, a10[j]);\n"
            "          const float sy = bot - top;\n"
            "          sa[j] = fmaf(fy, sy, top);\n"
            "          const float sx = fmaf(fy, e23 - e01, e01);\n",
            "          const float sy = e01, sx = e23;\n"
            "          sa[j] = a00[j];\n")]),
        ("without the dx additions", [(
            "          red4_if<VEC>((flags >> (4 + n) & 1) && n_c > 0,",
            "          red4_if<VEC>((flags >> (4 + n) & 1) && n_c > 0 && dv[n].x == 12345.f,")]),
        ("without the corner loads", [(
            "          v[n] = (flags >> n & 1) && n_c > 0 ? ldg4<VEC>(xq + step[n] + h * 32, n_c)\n"
            "                                             : make_float4(0.f, 0.f, 0.f, 0.f);",
            "          v[n] = make_float4((float)e.x, (float)n, (float)cl, 1.f);")]),
        ("with every pixel's offsets read from one pixel's", [
            ("? off + ((size_t)(b * H + yy) * W + xx) * (2 * K) + (i - p * 2 * K)\n"
             "                              : off, ok);",
             "? off + (i - p * 2 * K) : off, ok);")]),
        ("without the d-offset shuffles and writes", [
            ("for (int m = kLanes / 2; m > 0; m >>= 1) {  // over the item's lanes",
             "for (int m = 0; m > 0; m >>= 1) {  // over the item's lanes"),
            ("      if (quad == 0 && live) {\n        float2* o",
             "      if (quad == 0 && live && sy == 12345.f) {\n        float2* o")]),
        ("without the dw partials and their sum", [
            ("      if (slot == 0) {\n        *reinterpret_cast<float4*>(s_dwp",
             "      if (slot == 0 && acc[h].x == 12345.f) {\n        *reinterpret_cast<float4*>(s_dwp"),
            ("  if (err) return err;\n  const int n_e", "  if (err || chunks) return err;\n  const int n_e")]),
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


_D2D_BWD_PLAN = kernels.deform2d_dw_bwd_plan


def _d2d_bwd(splits=None, nq=None):
    """deform2d_dw_bwd_plan with other warps a tap row (`splits`) or
    channel quads a lane (`nq`), its tile kept."""
    def plan(B, H, W, C, k, dil):
        base = _D2D_BWD_PLAN(B, H, W, C, k, dil)
        values = list(base.params)
        for i, v in ((8, splits), (9, nq)):
            values[i] = values[i] if v is None else v
        values[10] = kernels.deform2d_dw_bwd_smem_bytes(*base.tile, k, values[8], values[9])
        CH = 32 * values[9]
        return dataclasses.replace(base, params=kernels._c_ints(*values),
                                   smem_bytes=values[10], threads=32 * k * values[8],
                                   channel_tile=CH, grid=(base.grid[0], -(-C // CH), 1),
                                   parts=-(-C // CH))
    return plan


# variant → (the plan function it replaces, the plan it runs with)
PLANS = {
    "one channel quad a lane (32-channel blocks)": ("deform2d_dw_bwd_plan", _d2d_bwd(nq=1)),
    "two channel quads a lane (64-channel blocks)": ("deform2d_dw_bwd_plan", _d2d_bwd(nq=2)),
    "one warp a tap row": ("deform2d_dw_bwd_plan", _d2d_bwd(splits=1)),
    "two warps a tap row": ("deform2d_dw_bwd_plan", _d2d_bwd(splits=2)),
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
    for name in ("dlka_deform_conv3d_bwd", "dlka_deform_dw_conv2d",
                 "dlka_deform_dw_conv2d_bwd"):
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


def cases(kernel: str, reach: float = 2.5, integers: float = 0.25):
    """(label, inputs, plain reference) at the kernel's site shapes, the 2D
    offsets uniform in ±`reach`, the backward's with a share `integers` of
    them exact integers."""
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
            g = torch.randn(24, S, S, C, device="cuda", generator=gen)
            for k, dil in DEFORM_SITES_2D:
                off = (torch.rand(24, S, S, 2 * k * k, device="cuda", generator=gen) * 2
                       - 1) * reach
                w = torch.randn(k, k, 1, C, device="cuda", generator=gen) / k
                label = f"B=24 {S}^2 C={C} k={k} dil={dil}"
                if kernel == "deform2d_dw":
                    yield label, (x, off, w, dil), lambda a=(x, off, w, dil): deform2d_plain(*a)
                else:
                    # phase 19's offsets: a quarter of them exact integers
                    off = torch.where(torch.rand(off.shape, device="cuda", generator=gen)
                                      < integers, off.round(), off)
                    yield label, (x, off, w, g, dil), \
                        lambda a=(x, off, w, g, dil): deform2d_bwd_plain(*a)


WRAPPERS = {"deform3d_bwd": "deform_conv3d_bwd", "deform2d_dw": "deform_dw_conv2d",
            "deform2d_dw_bwd": "deform_dw_conv2d_bwd"}


def _wrapper_of(root: Path, kernel: str):
    """`kernel`'s wrapper from the checkout at `root`: its ops/kernels.py
    loaded under a name of its own, so that it builds and binds its own
    sources into root's build directory."""
    name = f"kernels_of_{abs(hash(str(root)))}"
    spec = importlib.util.spec_from_file_location(
        name, root / "deformablelka_tpu_torch" / "ops" / "kernels.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module  # its dataclasses look their module up
    spec.loader.exec_module(module)
    return getattr(module, WRAPPERS[kernel])


def ablate(kernel: str, workdir: Path, reach: float = 2.5, cold: bool = False,
           against: Path | None = None, integers: float = 0.25) -> dict:
    src = kernels._PKG / "csrc" / f"{kernel}.cu"
    libs = build_variants(src, VARIANTS[kernel], workdir)
    wrapper = getattr(kernels, WRAPPERS[kernel])
    base = kernels.library()
    calls = {v: _variant(lib, base, wrapper, PLANS.get(v)) for v, lib in libs.items()}
    if against is not None:
        calls[f"the kernel of {against}"] = _wrapper_of(against, kernel)
    timer = cold_ms if cold else _events_ms
    table = {}
    for label, args, plain in cases(kernel, reach, integers):
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
                try:
                    times[v].append(timer(lambda: calls[v](*args)))
                except RuntimeError as err:  # a plan the card refuses: too much shared memory
                    times[v].append(float("nan"))
                    if i == 0:
                        print(f"ablation {kernel} {label}: variant {v!r} not run: {err}",
                              flush=True)
        row = {v: float(np.median(t)) for v, t in times.items()}
        table[label] = row
        full = row["full"]
        where = " (cold L2)" if cold else ""
        print(f"ablation {kernel}{where} {label}: full {full:.4f} ms (max|err| vs "
              f"plain {max(errs):.3e}); " + "; ".join(
                  f"{v} {t:.4f} ms ({t - full:+.4f})" for v, t in row.items() if v != "full"),
              flush=True)
        torch.cuda.empty_cache()
    return table


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default="deform3d_bwd,deform2d_dw,deform2d_dw_bwd")
    ap.add_argument("--json", type=Path, default=None)
    ap.add_argument("--reach", type=float, default=2.5,
                    help="the 2D kernels' offsets uniform in ±reach")
    ap.add_argument("--integers", type=float, default=0.25,
                    help="the share of the 2D backward's offsets that are exact integers")
    ap.add_argument("--cold", action="store_true",
                    help="time each call with the L2 cache flushed before it")
    ap.add_argument("--against", type=Path, default=None,
                    help="another checkout whose kernel is timed in the same turns")
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
            out[kernel] = ablate(kernel, Path(tmp), args.reach, args.cold,
                                 args.against.resolve() if args.against else None,
                                 args.integers)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
