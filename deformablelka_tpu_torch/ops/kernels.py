"""The hand-written Hopper kernels: their build, binding and wrappers.

`csrc/*.cu` expose `extern "C"` launchers. At first use on a CUDA tensor
each source is compiled by its own `nvcc` process (all started together)
for `sm_90a`, the objects are linked into one shared library under
`deformablelka_tpu_torch/_build/`, named by a hash of the sources and
flags, and the library is loaded with `ctypes`. nvcc is taken from PATH,
else from `$CUDA_HOME/bin`.

Each wrapper takes the JAX package's layouts, checks device, dtype, shape
and contiguity, allocates its outputs with `torch.empty` (or `torch.zeros`
where the kernel accumulates with atomics), launches on the current stream
and raises if the launch failed. On a CPU tensor it computes the plain
PyTorch version instead, which autograd differentiates; on a CUDA tensor it
launches the kernel or raises, and never falls back. On a CUDA tensor
each forward wrapper is a `torch.autograd.Function`: `deform_conv3d`'s
backward launches the backward kernel (`deform_conv3d_bwd`); those of
`dw_chain3d`, `deform_dw_conv2d`, `dw_chain2d` and `dwconv3d` are the VJPs
of their plain versions, recomputed. `wrapper.launches` counts each kernel's
launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from deformablelka_tpu_torch.ops.deform2d import deform_dw_conv2d as deform_dw_conv2d_plain
from deformablelka_tpu_torch.ops.deform3d import deform_conv3d as deform_conv3d_plain
from deformablelka_tpu_torch.ops.deform3d import deform_conv3d_backward
from deformablelka_tpu_torch.ops.dwconv3d import depthwise_conv3d_dilated as dwconv3d_plain
from deformablelka_tpu_torch.ops.lka import dw_chain2d as dw_chain2d_plain
from deformablelka_tpu_torch.ops.lka import dw_chain3d as dw_chain3d_plain

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; "
                       "the CUDA kernels cannot be built")


def _build() -> Path:
    """Compile every source in parallel and link one shared library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    lib_path = BUILD_DIR / f"libdlka_kernels_{h.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in SOURCES:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        errors = []
        for src, proc in zip(SOURCES, procs):
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src.name}:\n{out}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(tmp_lib, lib_path)  # atomic against a concurrent build
    return lib_path


def library() -> ctypes.CDLL:
    """The kernels' shared library, built at first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.dlka_deform_conv3d.argtypes = [ptr] * 5 + [i32] * 6 + [ptr]
        lib.dlka_deform_conv3d.restype = i32
        lib.dlka_deform_conv3d_bwd.argtypes = [ptr] * 7 + [i32] * 6 + [ptr]
        lib.dlka_deform_conv3d_bwd.restype = i32
        lib.dlka_dw_chain3d.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
        lib.dlka_dw_chain3d.restype = i32
        lib.dlka_deform_dw_conv2d.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
        lib.dlka_deform_dw_conv2d.restype = i32
        lib.dlka_dw_chain2d.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        lib.dlka_dw_chain2d.restype = i32
        lib.dlka_dwconv3d.argtypes = [ptr] * 4 + [i32] * 7 + [ptr]
        lib.dlka_dwconv3d.restype = i32
        lib.dlka_error_string.argtypes = [i32]
        lib.dlka_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(err: int, name: str) -> None:
    if err != 0:
        msg = library().dlka_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def _require(t: torch.Tensor, name: str, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _check_deform(x, offset, w):
    B, D, H, W, Ci = x.shape
    dev = x.device
    _require(x, "x", (B, D, H, W, Ci), dev)
    _require(offset, "offset", (B, D, H, W, 81), dev)
    _require(w, "w", (3, 3, 3, Ci, w.shape[-1]), dev)
    if B * D * H * W >= 2 ** 31:
        raise ValueError("deform_conv3d kernel: too many voxels for int32 indices")


def _deform_forward(x, offset, w, bias):
    _check_deform(x, offset, w)
    B, D, H, W, Ci = x.shape
    Co = w.shape[-1]
    if bias is not None:
        _require(bias, "bias", (Co,), x.device)
    y = torch.empty(B, D, H, W, Co, device=x.device, dtype=torch.float32)
    err = library().dlka_deform_conv3d(
        x.data_ptr(), offset.data_ptr(), w.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(),
        B, D, H, W, Ci, Co, _stream())
    _check(err, "deform_conv3d")
    deform_conv3d.launches += 1
    return y


class _DeformConv3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, offset, w, bias):
        ctx.save_for_backward(x, offset, w)
        ctx.has_bias = bias is not None
        return _deform_forward(x, offset, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, offset, w = ctx.saved_tensors
        g = g.contiguous()
        dx, doff, dw = deform_conv3d_bwd(x, offset, w, g)
        # the JAX package adds the bias outside its kernel (ops/__init__.py:239)
        dbias = g.sum((0, 1, 2, 3)) if ctx.has_bias else None
        return dx, doff, dw, dbias


def deform_conv3d(x, offset, w, bias=None):
    """3³ deformable conv, stride 1, pad 1, dilation 1, groups 1.

    x (B, D, H, W, Ci), offset (B, D, H, W, 81), w (3, 3, 3, Ci, Co),
    bias (Co,) or None → (B, D, H, W, Co). Kernel: csrc/deform3d.cu;
    its gradient: `deform_conv3d_bwd`.
    """
    if not x.is_cuda:
        return deform_conv3d_plain(x, offset, w, bias)
    return _DeformConv3d.apply(x, offset, w, bias)


deform_conv3d.launches = 0


def deform_conv3d_bwd(x, offset, w, g):
    """(dx, d-offset, dw) of `deform_conv3d(x, offset, w)` at the cotangent
    g (B, D, H, W, Co): the exact trilinear gradient, right derivative at
    integer offsets. Kernel: csrc/deform3d_bwd.cu (two launches, counted
    as one call)."""
    if not x.is_cuda:
        return deform_conv3d_backward(x, offset, w, g)
    _check_deform(x, offset, w)
    B, D, H, W, Ci = x.shape
    Co = w.shape[-1]
    _require(g, "g", (B, D, H, W, Co), x.device)
    dx = torch.zeros_like(x)
    doff = torch.empty_like(offset)
    dw = torch.zeros_like(w)
    err = library().dlka_deform_conv3d_bwd(
        x.data_ptr(), offset.data_ptr(), w.data_ptr(), g.data_ptr(),
        dx.data_ptr(), doff.data_ptr(), dw.data_ptr(),
        B, D, H, W, Ci, Co, _stream())
    _check(err, "deform_conv3d_bwd")
    deform_conv3d_bwd.launches += 1
    return dx, doff, dw


deform_conv3d_bwd.launches = 0

# dw_chain3d keeps, per channel of its tile of CT, 7 whole H×W planes and
# 5 haloed input planes in shared memory; CT is the widest that keeps that
# within 72 KB (three blocks per SM), else 1 channel within the 227 KB a
# block may hold.
_CHAIN_SMEM_TARGET = 72 * 1024
_SMEM_MAX = 232448


def chain_channel_tile(H: int, W: int, C: int) -> int:
    plane_bytes = 4 * (7 * H * W + 5 * (H + 4) * (W + 4))
    for ct in (32, 16, 8, 4, 2):
        if C % ct == 0 and plane_bytes * ct <= _CHAIN_SMEM_TARGET:
            return ct
    if plane_bytes <= _SMEM_MAX:
        return 1
    raise ValueError(f"dw_chain3d kernel: an {H}×{W} plane does not fit "
                     "shared memory")


def _chain_forward(x, w_dw, b_dw, w_dil, b_dil):
    B, D, H, W, C = x.shape
    dev = x.device
    _require(x, "x", (B, D, H, W, C), dev)
    _require(w_dw, "w_dw", (5, 5, 5, 1, C), dev)
    _require(b_dw, "b_dw", (C,), dev)
    _require(w_dil, "w_dil", (7, 7, 7, 1, C), dev)
    _require(b_dil, "b_dil", (C,), dev)
    ct = chain_channel_tile(H, W, C)
    y = torch.empty_like(x)
    err = library().dlka_dw_chain3d(
        x.data_ptr(), w_dw.data_ptr(), b_dw.data_ptr(), w_dil.data_ptr(),
        b_dil.data_ptr(), y.data_ptr(), B, D, H, W, C, ct, _stream())
    _check(err, "dw_chain3d")
    dw_chain3d.launches += 1
    return y


class _PlainVjp(torch.autograd.Function):
    """Forward: `kernel(*inputs)`. Backward: the VJP of `plain(*inputs)`,
    recomputed (cuDNN or PyTorch's own kernels on the card), as the JAX
    package differentiates a plain form of its fused chains and of its 2D
    deform kernel (`lka_fused_kernel.py` `_c3_bwd`/`_c2_bwd`,
    `deform2d_kernel.py` `_bwd`): it has no backward kernel for them, and
    the port's are later work (ROADMAP). For the 2D deform conv the plain
    form is the gather, whose offset gradient at an integer offset is the
    right derivative x(y0 + 1) − x(y0); the JAX window VJP gives 0 there."""

    @staticmethod
    def forward(ctx, kernel, plain, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need) for t, need
                  in zip(ctx.saved_tensors, ctx.needs_input_grad[2:])]
        with torch.enable_grad():
            y = ctx.plain(*inputs)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(y, wanted, g))
        return (None, None, *(next(grads) if t.requires_grad else None
                              for t in inputs))


def dw_chain3d(x, w_dw, b_dw, w_dil, b_dil):
    """dw5³ (pad 2) + bias → dw7³ dilation 3 (pad 9) + bias, fused.

    x (B, D, H, W, C), w_dw (5, 5, 5, 1, C), b_dw (C,), w_dil (7, 7, 7, 1,
    C), b_dil (C,) → (B, D, H, W, C). Kernel: csrc/dw_chain3d.cu.
    """
    if not x.is_cuda:
        return dw_chain3d_plain(x, w_dw, b_dw, w_dil, b_dil)
    return _PlainVjp.apply(_chain_forward, dw_chain3d_plain,
                           x, w_dw, b_dw, w_dil, b_dil)


dw_chain3d.launches = 0


def _deform_dw_forward(x, offset, w, dil):
    B, H, W, C = x.shape
    dev = x.device
    k = w.shape[0]
    if k % 2 == 0 or dil < 1:
        raise ValueError(f"deform_dw_conv2d kernel: odd k and dil >= 1 only, "
                         f"got k {k}, dil {dil}")
    _require(x, "x", (B, H, W, C), dev)
    _require(offset, "offset", (B, H, W, 2 * k * k), dev)
    _require(w, "w", (k, k, 1, C), dev)
    if B * H * W * max(C, 2 * k * k) >= 2 ** 31:
        raise ValueError("deform_dw_conv2d kernel: too many elements for int32 indices")
    y = torch.empty_like(x)
    err = library().dlka_deform_dw_conv2d(
        x.data_ptr(), offset.data_ptr(), w.data_ptr(), y.data_ptr(),
        B, H, W, C, k, dil, _stream())
    _check(err, "deform_dw_conv2d")
    deform_dw_conv2d.launches += 1
    return y


def deform_dw_conv2d(x, offset, w, dil: int = 1):
    """Depthwise k×k deformable conv, stride 1, dilation `dil`, padding
    (k // 2)·dil, one offset group, no bias; bilinear, zero outside the
    image, exact for any offset.

    x (B, H, W, C), offset (B, H, W, 2k²) with (Δy, Δx) per tap, taps
    row-major, w (k, k, 1, C) → (B, H, W, C). Kernel: csrc/deform2d_dw.cu.
    """
    if not x.is_cuda:
        return deform_dw_conv2d_plain(x, offset, w, dil)
    return _PlainVjp.apply(
        lambda *t: _deform_dw_forward(*t, dil),
        lambda *t: deform_dw_conv2d_plain(*t, dil), x, offset, w)


deform_dw_conv2d.launches = 0


def chain2d_channel_tile(H: int, W: int, C: int) -> int:
    """dw_chain2d keeps, per channel of its tile of CT, the haloed input
    plane and the dw5 plane in shared memory; CT is the widest that keeps
    that within 72 KB, else 1 channel within the 227 KB a block may hold."""
    plane_bytes = 4 * ((H + 4) * (W + 4) + H * W)
    for ct in (32, 16, 8, 4, 2):
        if C % ct == 0 and plane_bytes * ct <= _CHAIN_SMEM_TARGET:
            return ct
    if plane_bytes <= _SMEM_MAX:
        return 1
    raise ValueError(f"dw_chain2d kernel: an {H}×{W} plane does not fit "
                     "shared memory")


def _chain2d_forward(x, w_dw, b_dw, w_dil, b_dil):
    B, H, W, C = x.shape
    dev = x.device
    _require(x, "x", (B, H, W, C), dev)
    _require(w_dw, "w_dw", (5, 5, 1, C), dev)
    _require(b_dw, "b_dw", (C,), dev)
    _require(w_dil, "w_dil", (7, 7, 1, C), dev)
    _require(b_dil, "b_dil", (C,), dev)
    ct = chain2d_channel_tile(H, W, C)
    y = torch.empty_like(x)
    err = library().dlka_dw_chain2d(
        x.data_ptr(), w_dw.data_ptr(), b_dw.data_ptr(), w_dil.data_ptr(),
        b_dil.data_ptr(), y.data_ptr(), B, H, W, C, ct, _stream())
    _check(err, "dw_chain2d")
    dw_chain2d.launches += 1
    return y


def dw_chain2d(x, w_dw, b_dw, w_dil, b_dil):
    """dw5² (pad 2) + bias → dw7² dilation 3 (pad 9) + bias, fused.

    x (B, H, W, C), w_dw (5, 5, 1, C), b_dw (C,), w_dil (7, 7, 1, C),
    b_dil (C,) → (B, H, W, C). Kernel: csrc/dw_chain2d.cu.
    """
    if not x.is_cuda:
        return dw_chain2d_plain(x, w_dw, b_dw, w_dil, b_dil)
    return _PlainVjp.apply(_chain2d_forward, dw_chain2d_plain,
                           x, w_dw, b_dw, w_dil, b_dil)


dw_chain2d.launches = 0

# dwconv3d keeps a block's (K³, 32 channels) weights in shared memory
_DW_CHANNEL_TILE = 32


def _dwconv3d_forward(x, w, bias, dil):
    B, D, H, W, C = x.shape
    dev = x.device
    K = w.shape[0]
    if tuple(w.shape[:3]) != (K, K, K) or K % 2 == 0 or dil < 1:
        raise ValueError(f"dwconv3d kernel: a cubic odd kernel and dil >= 1 "
                         f"only, got w {tuple(w.shape)}, dil {dil}")
    _require(x, "x", (B, D, H, W, C), dev)
    _require(w, "w", (K, K, K, 1, C), dev)
    if bias is not None:
        _require(bias, "bias", (C,), dev)
    if B * D * H * W * C >= 2 ** 31:
        raise ValueError("dwconv3d kernel: too many elements for int32 indices")
    if 4 * K ** 3 * _DW_CHANNEL_TILE > _SMEM_MAX:
        raise ValueError(f"dwconv3d kernel: K={K} weights do not fit shared memory")
    y = torch.empty_like(x)
    err = library().dlka_dwconv3d(
        x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
        y.data_ptr(), B, D, H, W, C, K, dil, _stream())
    _check(err, "dwconv3d")
    dwconv3d.launches += 1
    return y


def dwconv3d(x, w, bias, dil: int):
    """Depthwise K³ conv, stride 1, dilation `dil`, padding dil·(K // 2),
    zero outside the volume, plus the bias.

    x (B, D, H, W, C), w (K, K, K, 1, C), bias (C,) or None → (B, D, H, W,
    C). Kernel: csrc/dwconv3d.cu.
    """
    if not x.is_cuda:
        return dwconv3d_plain(x, w, bias, dil)
    if bias is None:
        return _PlainVjp.apply(lambda x, w: _dwconv3d_forward(x, w, None, dil),
                               lambda x, w: dwconv3d_plain(x, w, None, dil), x, w)
    return _PlainVjp.apply(lambda *t: _dwconv3d_forward(*t, dil),
                           lambda *t: dwconv3d_plain(*t, dil), x, w, bias)


dwconv3d.launches = 0

WRAPPERS = (deform_conv3d, dw_chain3d, deform_conv3d_bwd, deform_dw_conv2d,
            dw_chain2d, dwconv3d)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
