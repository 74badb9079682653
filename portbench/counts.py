"""The yardstick's arithmetic: the chip's peaks, each hand kernel's
operations and bytes, and the count of a unit of work on the plain
reference.

The formulas are those the port's kernels were bounded by when they were
built (`chip_smoke.py`'s bounds, `utils/profiling.kernel_ops`), with one
change: a depthwise chain counts only the taps that fall inside the map,
since a zero-padded tap is work that no implementation needs to do.
Each input byte is read once and each output byte written once. The
least time of a call is the larger of its bytes over the memory's rate
and its operations over their rate. The channel mix of the 3D deform
conv and of its backward is a GEMM, which an implementation exact in
float32 can run as three TF32 products on the tensor cores; it is bounded
there, and the rest of the call (the blend) on the float32 units, the two
in parallel. So no correct float32 implementation reads above 100 %.

`count_unit` walks a reference on the meta device under torch's
`FlopCounterMode`, with each hand-kernel site replaced by a stand-in that
records its shapes; it never runs the program.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count

from portbench.reference import plain

# NVIDIA H100 SXM, data sheet, dense
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12


def taps_inside(extent: int, k: int, dil: int) -> int:
    """Σ over the positions of one axis of the k taps (dilation `dil`,
    centred) that fall inside it."""
    return sum(0 <= z + (t - k // 2) * dil < extent for z in range(extent) for t in range(k))


def _least(n_bytes, f32_flops, tc_flops=0.0):
    return max(n_bytes / HBM_BYTES_PER_S, f32_flops / F32_FLOP_PER_S,
               3 * tc_flops / TF32_FLOP_PER_S)


def kernel_work(name: str, shapes: dict) -> dict:
    """{"flops", "bytes", "least_s"} of one call of hand kernel `name` at
    `shapes` (channels-first input "x" and, where it matters, the output
    channels "co" or the kernel size "k")."""
    x = shapes["x"]
    B, C = x[0], x[1]
    V = math.prod(x[2:])
    if name == "deform_conv3d":
        co = shapes["co"]
        mix, blend = B * V * 27 * 2 * C * co, B * V * 27 * 16 * C
        n_bytes = 4 * (B * V * (C + 81 + co) + 27 * C * co + co)
        return {"flops": mix + blend, "bytes": n_bytes, "least_s": _least(n_bytes, blend, mix)}
    if name == "deform_conv3d_bwd":
        co = shapes["co"]
        mix, rest = B * V * 27 * 4 * C * co, B * V * 27 * (48 * C + 48)
        n_bytes = 4 * (B * V * (C + 81 + co) + 27 * C * co + B * V * (C + 81) + 27 * C * co)
        return {"flops": mix + rest, "bytes": n_bytes, "least_s": _least(n_bytes, rest, mix)}
    if name == "dw_chain3d":
        sp = x[2:]
        t5 = math.prod(taps_inside(s, 5, 1) for s in sp)
        t7 = math.prod(taps_inside(s, 7, 3) for s in sp)
        flops = 2 * B * C * (t5 + t7)
        n_bytes = 4 * (2 * B * V * C + (125 + 343 + 2) * C)
        return {"flops": flops, "bytes": n_bytes, "least_s": _least(n_bytes, flops)}
    if name == "deform_dw_conv2d":
        K = shapes["k"] ** 2
        flops = B * V * C * K * 9
        n_bytes = 4 * (B * V * (2 * C + 2 * K) + K * C)
        return {"flops": flops, "bytes": n_bytes, "least_s": _least(n_bytes, flops)}
    if name == "deform_dw_conv2d_bwd":
        K = shapes["k"] ** 2
        flops = B * V * K * (32 * C + 24)
        n_bytes = 4 * (B * V * (2 * C + 2 * K) + K * C + B * V * (C + 2 * K) + K * C)
        return {"flops": flops, "bytes": n_bytes, "least_s": _least(n_bytes, flops)}
    raise KeyError(name)


def _stand_in(name, tally, out_shape):
    """A hand-kernel site on the meta device: records its call (and, in
    the backward pass, its backward's) and returns an empty output of the
    right shape inside the autograd graph."""

    class StandIn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            ctx.site = _site_shapes(name, args)
            ctx.in_shapes = [a.shape if torch.is_tensor(a) else None for a in args]
            tally.append((name, ctx.site))
            return args[0].new_empty(out_shape(args))

        @staticmethod
        def backward(ctx, g):
            tally.append((name + "_bwd", ctx.site))
            return tuple(None if s is None else g.new_empty(s) for s in ctx.in_shapes)

    return StandIn.apply


def _site_shapes(name, args):
    x = args[0]
    shapes = {"x": tuple(x.shape)}
    if name == "deform_conv3d":
        shapes["co"] = args[2].shape[0]
    if name == "deform_dw_conv2d":
        shapes["k"] = args[2].shape[-1]
    return shapes


_OUT = {"deform_conv3d": lambda a: (a[0].shape[0], a[2].shape[0], *a[0].shape[2:]),
        "dw_chain3d": lambda a: tuple(a[0].shape),
        "deform_dw_conv2d": lambda a: tuple(a[0].shape)}


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding,
                         _dilation, transposed, _output_padding, _groups, output_mask,
                         out_shape=None, **_):
    """A convolution's input and weight gradients cost its forward each.
    (torch's own formula counts a grouped conv's gradients as if it were
    dense: a depthwise conv's backward `groups` times over.)"""
    return conv_flop_count(x_shape, w_shape, grad_out_shape, transposed) * (
        int(output_mask[0]) + int(output_mask[1]))


@contextlib.contextmanager
def _counting(tally):
    saved = dict(plain.KERNELS)
    try:
        for name in saved:
            plain.KERNELS[name] = _stand_in(name, tally, _OUT[name])
        yield
    finally:
        plain.KERNELS.update(saved)


def count_unit(fn, times: int = 1) -> dict:
    """Run `fn()` (a reference forward, or a forward and its backward, on
    meta tensors) and count it: {"dense_flops": what torch's counter saw
    outside the hand-kernel sites, "kernels": {name: {"calls", "flops",
    "bytes", "least_s"}}, "flops": all of it}, each multiplied by `times`
    (the unit's repeats of `fn`). A depthwise chain's backward, which the
    program leaves to cuDNN, counts as twice its forward."""
    tally = []
    counter = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _conv_backward_flops})
    with counter, _counting(tally):
        fn()
    kernels = {}
    for name, shapes in tally:
        if name == "dw_chain3d_bwd":
            work = {k: 2 * v for k, v in kernel_work("dw_chain3d", shapes).items()}
        else:
            work = kernel_work(name, shapes)
        k = kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0, "least_s": 0.0})
        k["calls"] += times
        for key in ("flops", "bytes", "least_s"):
            k[key] += times * work[key]
    dense = times * counter.get_total_flops()
    return {"dense_flops": dense, "kernels": kernels,
            "flops": dense + sum(k["flops"] for k in kernels.values())}


def roofline_share(ctx, kernel: str, launch_pattern: str):
    """A hand kernel's share of its roofline over a traced stretch, in %:
    Σ over its launches of the least time a call needs (the launches
    counted in the trace by `launch_pattern`, each the mean call of the
    unit as the reference counts it) over the device time of its class.
    None where the stretch ran none of it."""
    work = ctx.counts["kernels"].get(kernel)
    launches = ctx.profile.launches_of(launch_pattern)
    busy = ctx.profile.class_s(f"hand:{kernel}")
    if not work or not launches or not busy:
        return None
    return 100.0 * launches * (work["least_s"] / work["calls"]) / busy
