"""The hand-written Hopper kernels: their build, binding and wrappers.

`csrc/*.cu` expose `extern "C"` launchers. At first use on a CUDA tensor
each source is compiled by its own `nvcc` process (all started together)
for `sm_90a`, the objects are linked into one shared library under
`deformablelka_tpu_torch/_build/`, named by a hash of the sources and
flags, and the library is loaded with `ctypes`. nvcc is taken from PATH,
else from `$CUDA_HOME/bin`.

Each wrapper takes the JAX package's layouts, checks device, dtype, shape
and contiguity, allocates its outputs with `torch.empty` (or `torch.zeros`
where the kernel accumulates with atomics; a scratch buffer where the
deform conv splits K over taps), launches on the current stream and raises
if the launch failed. On a CPU tensor it computes the plain
PyTorch version instead, which autograd differentiates; on a CUDA tensor it
launches the kernel or raises, and never falls back. Where autograd will
ask for a gradient (grad mode on and an input that requires one), a
forward wrapper on a CUDA tensor is a `torch.autograd.Function`:
`deform_conv3d`'s backward launches its backward kernel
(`deform_conv3d_bwd`), and so does `deform_dw_conv2d`'s
(`deform_dw_conv2d_bwd`); those of `dw_chain3d`, `dw_chain2d` and
`dwconv3d` are the VJPs of their plain versions, recomputed. Otherwise
the forward launches alone. Every launcher takes its pointers and its
launch plan (`deform3d_plan`, `chain3d_plan`, `deform3d_bwd_plan`,
`deform2d_dw_plan`, `deform2d_dw_bwd_plan`, `chain2d_plan`,
`dwconv3d_plan`: pure functions of the shape, cached) as two arrays: at
the small shapes the host's time per call sets the pace.
`wrapper.launches` counts each kernel's calls (the deform conv's second
pass, which adds the parts of a split K, is part of its one call, as are
the backward's weight GEMM and its sum of parts, and the 2D backward's sum
of dw's per-tile parts).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
from dataclasses import dataclass, field
from pathlib import Path

import torch

from deformablelka_tpu_torch.ops.deform2d import deform_dw_conv2d as deform_dw_conv2d_plain
from deformablelka_tpu_torch.ops.deform2d import deform_dw_conv2d_backward
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
        i32 = ctypes.c_int
        # (pointers, plan, vec): no argtypes, so that ctypes passes the two
        # arrays as pointers and vec as an int without converting each
        lib.dlka_deform_conv3d.restype = i32
        lib.dlka_deform_conv3d_bwd.restype = i32
        lib.dlka_deform_dw_conv2d.restype = i32
        lib.dlka_deform_dw_conv2d_bwd.restype = i32
        lib.dlka_dw_chain3d.restype = i32
        lib.dlka_dw_chain2d.restype = i32
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
    """Raise unless `t` is a contiguous float32 tensor of `shape` on
    `device`; one test on the way that passes, the message after."""
    if _fits(t, shape, device):
        return
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    raise ValueError(f"{name} must be contiguous")


def _fits(t: torch.Tensor, shape: tuple, device) -> bool:
    """`_require`'s conditions as one test."""
    return (t.dtype is torch.float32 and t.device == device and t.shape == shape
            and t.is_contiguous())


def _stream(device: torch.device) -> int:
    """The current stream's handle on `device`, read without building a
    `torch.cuda.Stream` object."""
    return torch._C._cuda_getCurrentRawStream(device.index)


_launch_args = threading.local()


def _pointers() -> ctypes.Array:
    """This thread's array of the pointers a launcher takes."""
    buf = getattr(_launch_args, "buf", None)
    if buf is None:
        buf = _launch_args.buf = (ctypes.c_uint64 * 10)()  # the most any launcher takes
    return buf


def _grad_needed(*inputs) -> bool:
    if torch.is_grad_enabled():
        for t in inputs:
            if t is not None and t.requires_grad:
                return True
    return False


def _dispatch(kernel, plain, *inputs):
    """`kernel(*inputs)`, through `_PlainVjp` only where autograd will ask
    for a gradient: under `no_grad`, or when no input requires one, the
    forward launches with no autograd Function around it."""
    if _grad_needed(*inputs):
        return _PlainVjp.apply(kernel, plain, *inputs)
    return kernel(*inputs)


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
    plan = deform3d_plan(B, D, H, W, Ci, Co)
    y = torch.empty(B, D, H, W, Co, device=x.device, dtype=torch.float32)
    scratch = (torch.empty(plan.parts * B * D * H * W * Co, device=x.device,
                           dtype=torch.float32) if plan.parts > 1 else None)
    a = _pointers()
    a[0] = xp = x.data_ptr()
    a[1] = offset.data_ptr()
    a[2] = wp = w.data_ptr()
    a[3] = 0 if bias is None else bias.data_ptr()
    a[4], a[5] = y.data_ptr(), 0 if scratch is None else scratch.data_ptr()
    a[6] = _stream(x.device)
    vec = plan.vec if xp % 16 == 0 and wp % 16 == 0 else 1
    err = (_lib or library()).dlka_deform_conv3d(a, plan.params, vec)
    if err:
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
    if not _grad_needed(x, offset, w, bias):
        return _deform_forward(x, offset, w, bias)
    return _DeformConv3d.apply(x, offset, w, bias)


deform_conv3d.launches = 0


def deform_conv3d_bwd(x, offset, w, g):
    """(dx, d-offset, dw) of `deform_conv3d(x, offset, w)` at the cotangent
    g (B, D, H, W, Co): the exact trilinear gradient, right derivative at
    integer offsets. Kernel: csrc/deform3d_bwd.cu (a data launch, a weight
    GEMM over its samples and, where the GEMM splits the voxels, a fixed-
    order sum of the parts: one call). Its scratch: the samples, 27 ×
    voxels × Ci floats."""
    if not x.is_cuda:
        return deform_conv3d_backward(x, offset, w, g)
    _check_deform(x, offset, w)
    B, D, H, W, Ci = x.shape
    Co = w.shape[-1]
    _require(g, "g", (B, D, H, W, Co), x.device)
    plan = deform3d_bwd_plan(B, D, H, W, Ci, Co)
    n = B * D * H * W
    if _TAPS * n * Ci >= 2 ** 31:
        raise ValueError("deform_conv3d_bwd kernel: too many samples for its scratch")
    dx = torch.zeros_like(x)
    # several channel chunks add into doff with atomics; one writes it
    doff = torch.zeros_like(offset) if plan.grid[1] > 1 else torch.empty_like(offset)
    dw = torch.empty_like(w)
    samp = torch.empty(_TAPS * n * Ci, device=x.device, dtype=torch.float32)
    part = (torch.empty(plan.parts * _TAPS * Ci * Co, device=x.device, dtype=torch.float32)
            if plan.parts > 1 else None)
    a = _pointers()
    a[0] = xp = x.data_ptr()
    a[1], a[2] = offset.data_ptr(), w.data_ptr()
    a[3] = gp = g.data_ptr()
    a[4], a[5], a[6] = dx.data_ptr(), doff.data_ptr(), dw.data_ptr()
    a[7], a[8] = samp.data_ptr(), 0 if part is None else part.data_ptr()
    a[9] = _stream(x.device)
    vec = plan.vec if xp % 16 == 0 and gp % 16 == 0 else 1
    err = (_lib or library()).dlka_deform_conv3d_bwd(a, plan.params, vec)
    if err:
        _check(err, "deform_conv3d_bwd")
    deform_conv3d_bwd.launches += 1
    return dx, doff, dw


deform_conv3d_bwd.launches = 0

def _chain_forward(x, w_dw, b_dw, w_dil, b_dil):
    B, D, H, W, C = x.shape
    dev = x.device
    if not (x.dtype is torch.float32 and x.is_contiguous()
            and _fits(w_dw, (5, 5, 5, 1, C), dev) and _fits(b_dw, (C,), dev)
            and _fits(w_dil, (7, 7, 7, 1, C), dev) and _fits(b_dil, (C,), dev)
            and B * D * H * W * C < 2 ** 31):
        for t, name, shape in ((x, "x", (B, D, H, W, C)), (w_dw, "w_dw", (5, 5, 5, 1, C)),
                               (b_dw, "b_dw", (C,)), (w_dil, "w_dil", (7, 7, 7, 1, C)),
                               (b_dil, "b_dil", (C,))):
            _require(t, name, shape, dev)
        raise ValueError("dw_chain3d kernel: too many elements for int32 indices")
    plan = chain3d_plan(B, D, H, W, C)
    y = torch.empty_like(x)
    a = _pointers()
    a[0] = xp = x.data_ptr()
    a[1], a[2], a[3], a[4] = w_dw.data_ptr(), b_dw.data_ptr(), w_dil.data_ptr(), b_dil.data_ptr()
    a[5], a[6] = y.data_ptr(), _stream(dev)
    err = (_lib or library()).dlka_dw_chain3d(a, plan.params,
                                              plan.vec if xp % 16 == 0 else 1)
    if err:
        _check(err, "dw_chain3d")
    dw_chain3d.launches += 1
    return y


class _PlainVjp(torch.autograd.Function):
    """Forward: `kernel(*inputs)`. Backward: the VJP of `plain(*inputs)`,
    recomputed (cuDNN or PyTorch's own kernels on the card), as the JAX
    package differentiates a plain form of its fused chains
    (`lka_fused_kernel.py` `_c3_bwd`/`_c2_bwd`): it has no backward kernel
    for them, and the port's are later work (ROADMAP). The chains and the
    dilated depthwise conv take it; the deform convs have backward kernels."""

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
    return _dispatch(_chain_forward, dw_chain3d_plain, x, w_dw, b_dw, w_dil, b_dil)


dw_chain3d.launches = 0


def _check_deform_dw(x, offset, w, dil):
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


def _deform_dw_forward(x, offset, w, dil):
    _check_deform_dw(x, offset, w, dil)
    B, H, W, C = x.shape
    plan = deform2d_dw_plan(B, H, W, C, w.shape[0], dil)
    y = torch.empty_like(x)
    a = _pointers()
    a[0] = xp = x.data_ptr()
    a[1] = offset.data_ptr()
    a[2] = wp = w.data_ptr()
    a[3], a[4] = y.data_ptr(), _stream(x.device)
    err = (_lib or library()).dlka_deform_dw_conv2d(
        a, plan.params, plan.vec if xp % 16 == 0 and wp % 16 == 0 else 1)
    if err:
        _check(err, "deform_dw_conv2d")
    deform_dw_conv2d.launches += 1
    return y


class _DeformDw2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, offset, w, dil):
        ctx.save_for_backward(x, offset, w)
        ctx.dil = dil
        return _deform_dw_forward(x, offset, w, dil)

    @staticmethod
    def backward(ctx, g):
        x, offset, w = ctx.saved_tensors
        dx, doff, dw = deform_dw_conv2d_bwd(x, offset, w, g.contiguous(), ctx.dil)
        return dx, doff, dw, None


def deform_dw_conv2d(x, offset, w, dil: int = 1):
    """Depthwise k×k deformable conv, stride 1, dilation `dil`, padding
    (k // 2)·dil, one offset group, no bias; bilinear, zero outside the
    image, exact for any offset.

    x (B, H, W, C), offset (B, H, W, 2k²) with (Δy, Δx) per tap, taps
    row-major, w (k, k, 1, C) → (B, H, W, C). Kernel: csrc/deform2d_dw.cu;
    its gradient: `deform_dw_conv2d_bwd`.
    """
    if not x.is_cuda:
        return deform_dw_conv2d_plain(x, offset, w, dil)
    if not _grad_needed(x, offset, w):
        return _deform_dw_forward(x, offset, w, dil)
    return _DeformDw2d.apply(x, offset, w, dil)


deform_dw_conv2d.launches = 0


def deform_dw_conv2d_bwd(x, offset, w, g, dil: int = 1):
    """(dx, d-offset, dw) of `deform_dw_conv2d(x, offset, w, dil)` at the
    cotangent g (B, H, W, C): the exact bilinear gradient, right derivative
    at integer offsets. Kernel: csrc/deform2d_dw_bwd.cu (a data launch and
    a fixed-order sum of dw's per-tile parts: one call). Its scratch: tiles
    × k² × C floats."""
    if not x.is_cuda:
        return deform_dw_conv2d_backward(x, offset, w, g, dil)
    _check_deform_dw(x, offset, w, dil)
    B, H, W, C = x.shape
    k = w.shape[0]
    _require(g, "g", (B, H, W, C), x.device)
    plan = deform2d_dw_bwd_plan(B, H, W, C, k, dil)
    n_part = plan.grid[0] * k * k * C
    if n_part >= 2 ** 31:
        raise ValueError("deform_dw_conv2d_bwd kernel: too many tiles for its scratch")
    # the kernel adds into dx, and writes doff only where a sample has a
    # corner inside the image
    dx = torch.zeros_like(x)
    doff = torch.zeros_like(offset)
    dw = torch.empty_like(w)
    part = torch.empty(n_part, device=x.device, dtype=torch.float32)
    a = _pointers()
    a[0] = xp = x.data_ptr()
    a[1], a[2] = offset.data_ptr(), w.data_ptr()
    a[3] = gp = g.data_ptr()
    a[4], a[5], a[6] = dx.data_ptr(), doff.data_ptr(), dw.data_ptr()
    a[7], a[8] = part.data_ptr(), _stream(x.device)
    vec = plan.vec if xp % 16 == 0 and gp % 16 == 0 else 1
    err = (_lib or library()).dlka_deform_dw_conv2d_bwd(a, plan.params, vec)
    if err:
        _check(err, "deform_dw_conv2d_bwd")
    deform_dw_conv2d_bwd.launches += 1
    return dx, doff, dw


deform_dw_conv2d_bwd.launches = 0


@dataclass(frozen=True)
class LaunchPlan:
    """How a kernel is cut into blocks: `channel_tile` channels per block,
    the spatial `tile` of each block's outputs, `vec` floats per access
    along C (4: 16-byte vectors, 1: scalars), the block's dynamic shared
    memory in bytes, the grid and the threads per block. `params`: the
    shape and the plan as the launcher reads them, one C int array (one
    ctypes argument, not a dozen)."""
    channel_tile: int
    tile: tuple
    vec: int
    smem_bytes: int
    grid: tuple
    threads: int
    params: ctypes.Array = field(compare=False, repr=False)
    parts: int = 1   # deform3d: the K split over taps; chain3d: the runs of a z phase;
                     # deform2d_dw_bwd: its channel chunks


_SMS = 132                   # H100 SXM streaming multiprocessors
_SMEM_MAX = 232448           # shared memory one block may hold
_SMEM_TWO_BLOCKS = 115712    # per block, for two blocks per SM (228 KB each, 1 KB reserved)
_R5, _R7 = 8, 14             # dw_chain2d's thread strips (csrc/dw_chain2d.cu kR5, kR7)


# csrc/deform3d.cu's BK (channels per K step), kRows and kThreads; the taps
_DEFORM_BK, _DEFORM_ROWS, _DEFORM_THREADS, _TAPS = 32, 64, 128, 27


def deform3d_smem_bytes(rows: int, bn: int, taps: int) -> int:
    """csrc/deform3d.cu's shared memory: two buffers each of the A tile
    (rows × 36 floats), of the B tile (32 × (bn + 8)) and of the corner
    table (rows × 8 weights and 8 indices); the rows' voxel indices; their
    offsets at the `taps` taps of a part (3 a tap, the pitch odd)."""
    return 4 * (2 * rows * (_DEFORM_BK + 4) + 2 * _DEFORM_BK * (bn + 8)
                + 2 * 2 * rows * 8 + rows + rows * (3 * taps | 1))


def _brick(rows: int, D: int, H: int, W: int) -> tuple:
    """log2 of the (z, y, x) sides of a brick of at most `rows` voxels: one
    doubling at a time to x, y, z in turn, none past the volume's side
    rounded up to a power of two."""
    caps = [max(0, n - 1).bit_length() for n in (D, H, W)]
    sides = [0, 0, 0]
    bits = rows.bit_length() - 1
    while bits:
        grown = False
        for axis in (2, 1, 0):
            if bits and sides[axis] < caps[axis]:
                sides[axis] += 1
                bits -= 1
                grown = True
        if not grown:
            break
    return tuple(sides)


@functools.lru_cache(maxsize=None)
def deform3d_plan(B: int, D: int, H: int, W: int, Ci: int, Co: int) -> LaunchPlan:
    """deform_conv3d's blocks: 64 output voxels (a brick, `tile`, of one
    volume) × `channel_tile` output channels (32 where Co ≤ 32, else 64),
    K over taps in `parts`: the fewest of 1, 3, 9, 27 parts that give three
    blocks per SM (27: one tap a block). 16-byte accesses where Ci % 4 = 0
    and Co % 4 = 0."""
    rows = _DEFORM_ROWS
    bn = 32 if Co <= 32 else 64
    lz, ly, lx = _brick(rows, D, H, W)
    blocks = B * -(-D >> lz) * -(-H >> ly) * -(-W >> lx) * -(-Co // bn)
    parts = next((p for p in (1, 3, 9) if blocks * p >= 3 * _SMS), _TAPS)
    smem = deform3d_smem_bytes(rows, bn, _TAPS // parts)
    vec = 4 if Ci % 4 == 0 and Co % 4 == 0 else 1
    return LaunchPlan(bn, (1 << lz, 1 << ly, 1 << lx), vec, smem,
                      (blocks // -(-Co // bn), -(-Co // bn), parts), _DEFORM_THREADS,
                      _c_ints(B, D, H, W, Ci, Co, bn, lz, ly, lx, parts, _TAPS // parts,
                              smem),
                      parts=parts)


# csrc/deform3d_bwd.cu's voxels per brick, input channels per data block
# and the weight GEMM's voxels a step
_BWD_ROWS, _BWD_CHUNK, _BWD_STEP = 64, 32, 32


@functools.lru_cache(maxsize=None)
def deform3d_bwd_plan(B: int, D: int, H: int, W: int, Ci: int, Co: int) -> LaunchPlan:
    """deform_conv3d_bwd's blocks. Data launch (`grid`, `tile`): a brick
    of 64 voxels of one volume (`_brick`) × 32 input channels
    (`channel_tile`) × a group of taps, the fewest of 1, 3, 9, 27 groups
    that give eight blocks per SM. Weight GEMM: tiles of 32 × 32 (Ci, Co ≤
    32) or 64 × 64 outputs, the voxels cut into `parts` runs of whole
    32-voxel steps, at least 4 steps a run, until its blocks hold 16 (32 ×
    32 tiles) or 32 warps per SM. 16-byte accesses where Ci % 4 = 0 and Co % 4 = 0. Both
    launches use static shared memory only (`smem_bytes` 0)."""
    lz, ly, lx = _brick(_BWD_ROWS, D, H, W)
    chunks = -(-Ci // _BWD_CHUNK)
    bricks = B * -(-D >> lz) * -(-H >> ly) * -(-W >> lx)
    groups = next((t for t in (1, 3, 9) if bricks * chunks * t >= 8 * _SMS), _TAPS)
    T = 32 if Ci <= 32 and Co <= 32 else 64
    tiles = -(-Ci // T) * -(-Co // T)
    warps = (T // 4) ** 2 // 32
    n = B * D * H * W
    steps = -(-n // _BWD_STEP)
    # warps of GEMM blocks per SM, and at least 4 steps a part: shorter
    # parts cost more in the sum over them than they gain (B=2, 4³×256: 2
    # parts of 2 steps 0.074 ms, 1 part 0.065). At B=2, half the parts runs
    # 2-7 % slower at 32³-8³, twice the parts within 1.2 %
    # (kernel_ablation.py, H100 80GB HBM3, 700 W)
    per_sm = 16 if T == 32 else 32
    parts = max(1, min(steps // 4, -(-per_sm * _SMS // (tiles * _TAPS * warps))))
    per_part = -(-steps // parts) * _BWD_STEP
    parts = -(-n // per_part)
    vec = 4 if Ci % 4 == 0 and Co % 4 == 0 else 1
    return LaunchPlan(_BWD_CHUNK, (1 << lz, 1 << ly, 1 << lx), vec, 0,
                      (bricks, chunks, groups), 256,
                      _c_ints(B, D, H, W, Ci, Co, lz, ly, lx, chunks, groups, _TAPS // groups,
                              T, parts, per_part),
                      parts=parts)


_D2D_PIXELS, _D2D_CHUNK = 32, 32   # csrc/deform2d_dw.cu: pixels a tile, channels a chunk


@functools.lru_cache(maxsize=None)
def deform2d_dw_plan(B: int, H: int, W: int, C: int, k: int, dil: int) -> LaunchPlan:
    """deform_dw_conv2d's blocks: a tile of at most 32 pixels of one image
    (`tile` = (rows, columns): of 4 … 16 columns, the one that leaves the
    fewest of its pixels outside the image, then the one closest to 8
    columns) × a run of whole 32-channel chunks (`channel_tile`): all of C,
    or the fewest parts that give three blocks per SM. The shared memory:
    the corner table (16 bytes per pixel and tap) and a chunk's tap
    weights. 16-byte accesses along C where C % 4 = 0."""
    def idle(tw):
        th = _D2D_PIXELS // tw
        return (-(-H // th) * th * -(-W // tw) * tw - H * W) / (th * tw)
    tw = min(range(4, 17), key=lambda tw: (idle(tw), abs(tw - 8)))
    th = _D2D_PIXELS // tw
    tiles = B * -(-H // th) * -(-W // tw)
    chunks = -(-C // _D2D_CHUNK)
    parts = next((p for p in range(1, chunks) if tiles * p >= 3 * _SMS), chunks)
    per_part = -(-chunks // parts) * _D2D_CHUNK
    smem = k * k * (th * tw * 16 + _D2D_CHUNK * 4)
    if smem > _SMEM_MAX:
        raise ValueError(f"deform_dw_conv2d kernel: a {k}x{k} corner table does not fit "
                         "shared memory")
    return LaunchPlan(per_part, (th, tw), 4 if C % 4 == 0 else 1, smem,
                      (tiles, -(-C // per_part), 1), 256,
                      _c_ints(B, H, W, C, k, dil, th, tw, per_part, smem))


# csrc/deform2d_dw_bwd.cu: channels a lane's quads cover (32 a quad),
# items a warp step, threads a block, registers a thread of its data kernel
# (nvcc -Xptxas -v, sm_90a)
_D2D_BWD_QUAD, _D2D_BWD_MAX_QUADS, _D2D_BWD_SLOTS, _D2D_BWD_THREADS = 32, 3, 4, 768
_D2D_BWD_REGS = 80


def deform2d_dw_bwd_smem_bytes(th: int, tw: int, k: int, splits: int, nq: int) -> int:
    """csrc/deform2d_dw_bwd.cu's shared memory for blocks of 32·nq channels:
    the chunk's tap weights, the tile's g, the warps' dw parts (one a
    split, tap and channel), the warps' corner tables for one tap (16 bytes
    an item slot), the tile's offsets and its pixels' indices and
    coordinates."""
    K, TP, CH = k * k, th * tw, _D2D_BWD_QUAD * nq
    slots = -(-TP // (_D2D_BWD_SLOTS * splits)) * _D2D_BWD_SLOTS
    return 4 * (CH * K * (1 + splits) + (CH + 2 * K + 2) * TP + 4 * k * splits * slots)


@functools.lru_cache(maxsize=None)
def deform2d_dw_bwd_plan(B: int, H: int, W: int, C: int, k: int, dil: int) -> LaunchPlan:
    """deform_dw_conv2d_bwd's blocks: a tile (`tile` = (rows, columns)) of
    8 … 64 pixels of one image (no side longer than the image's) × one
    chunk of 32·nq channels (`channel_tile`; nq = ⌈C / 32⌉ up to 3 channel
    quads a lane; `parts` chunks, which add into doff with atomics where
    there are several); `splits` warps a tap row, each over ⌈th·tw /
    splits⌉ pixels (the most up to 768 threads, at least 16 pixels a
    warp). The tile: among those that keep 16 warps on an SM, else the most
    warps, the one with the least work (the dx additions of its warps' item
    slots, idle ones included, and the x its samples reach within ±2 of
    their taps, through L1), then the most pixels, then the squarest.
    16-byte accesses along C where C % 4 = 0."""
    if k % 2 == 0 or dil < 1 or 32 * k > _D2D_BWD_THREADS:
        raise ValueError(f"deform_dw_conv2d_bwd kernel: odd k ≤ {_D2D_BWD_THREADS // 32} "
                         f"and dil >= 1 only, got k {k}, dil {dil}")
    if max(H, W) >= 16384 or H * W * C >= 2 ** 31:
        raise ValueError("deform_dw_conv2d_bwd kernel: H and W below 16384 and an image "
                         "of fewer than 2^31 elements only")
    K, reach = k * k, 2 * ((k // 2) * dil + 2) + 1
    nq = min(_D2D_BWD_MAX_QUADS, -(-C // _D2D_BWD_QUAD))

    def splits(th, tw):
        return max(s for s in range(1, th * tw // 16 + 2)
                   if 32 * k * s <= _D2D_BWD_THREADS and (s == 1 or th * tw // s >= 16))

    def smem(th, tw):
        return deform2d_dw_bwd_smem_bytes(th, tw, k, splits(th, tw), nq)

    def warps_per_sm(th, tw):
        threads = 32 * k * splits(th, tw)
        return min(2048 // threads, 65536 // (_D2D_BWD_REGS * threads),
                   (_SMEM_MAX + 1024) // (smem(th, tw) + 1024)) * threads // 32

    def cost(tile):
        th, tw = tile
        sp = splits(th, tw)
        slots = sp * -(-(-(-th * tw // sp)) // _D2D_BWD_SLOTS) * _D2D_BWD_SLOTS
        return (-min(16, warps_per_sm(th, tw)),
                B * -(-H // th) * -(-W // tw) * (3 * K * slots + (th + reach) * (tw + reach)),
                -th * tw, abs(th - tw))

    tiles = [(th, tw) for tw in range(1, min(W, 64) + 1) for th in range(1, min(H, 64 // tw) + 1)
             if th * tw >= min(8, H * W) and smem(th, tw) <= _SMEM_MAX]
    if not tiles:
        raise ValueError(f"deform_dw_conv2d_bwd kernel: a {k}x{k} tile does not fit "
                         "shared memory")
    th, tw = min(tiles, key=cost)
    sp = splits(th, tw)
    CH = _D2D_BWD_QUAD * nq
    chunks = -(-C // CH)
    return LaunchPlan(CH, (th, tw), 4 if C % 4 == 0 else 1, smem(th, tw),
                      (B * -(-H // th) * -(-W // tw), chunks, 1), 32 * k * sp,
                      _c_ints(B, H, W, C, k, dil, th, tw, sp, nq, smem(th, tw)),
                      parts=chunks)


def _vec(ct: int, C: int) -> int:
    return 4 if ct % 4 == 0 and C % 4 == 0 else 1


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


_R5_3D, _R7_3D = 8, 8   # csrc/dw_chain3d.cu kR5, R7


def _bank_pitch(n: int, W: int) -> int:
    """The smallest channel pitch ≥ n that puts a warp's lanes (along x,
    then across channels where W < 32) on distinct banks: ≡ W (mod 32)
    where W < 32, else ≡ 4 (mod 8) against conflicts in 16-byte staging."""
    if W < 32:
        return n + (W - n) % 32
    return n + (4 - n) % 8


def chain3d_ring_rows(H: int, rows: int) -> int:
    """The intermediate rows a band of `rows` output rows keeps in the ring:
    the most, over the bands, of its rows ± 9 inside [0, H), and at least
    one dw5 strip."""
    need = max(min(H, r0 + rows + 9) - max(0, r0 - 9) for r0 in range(0, H, rows))
    return max(_R5_3D, need)


def chain3d_layout(H: int, W: int, ct: int, rows: int) -> tuple:
    """csrc/dw_chain3d.cu's shared memory for bands of `rows` output rows of
    `ct` channels: (ring rows, ring channel pitch, staged-plane channel
    pitch, bytes). The ring holds 7 intermediate planes of the band's rows
    ± 9, each with a zero row and a zero column (row pitch W + 1); the
    staged plane one input plane of those rows ± 2 with a zero frame of 2,
    and later the band's output rows."""
    rhp = chain3d_ring_rows(H, rows)
    ring_chan = _bank_pitch((rhp + 1) * (W + 1), W)
    in_chan = _bank_pitch(max((rhp + 4) * (W + 4), max(rows, _R7_3D) * W), W)
    return rhp, ring_chan, in_chan, 4 * ct * (7 * ring_chan + in_chan)


@functools.lru_cache(maxsize=None)
def chain3d_plan(B: int, D: int, H: int, W: int, C: int) -> LaunchPlan:
    """dw_chain3d's blocks: bands of `rows` output rows (`tile`) of `ct`
    channels of one z phase of one volume, the phase's outputs cut into
    `parts` runs. The tallest band (the fewest dw5 halo rows recomputed) of
    8 or 4 channels (16-byte vectors) that fits the 227 KB a block may hold,
    the wider tile first; 4 channels instead of 8 where that alone fills
    the card (two blocks per SM where a block fits half an SM's shared
    memory, else one); narrower tiles only where no such band fits. Then
    the phases are cut into runs (each recomputes 6 intermediate planes)
    until the grid fills the card or a run is one output. Threads: one
    8-row dilated strip each, 128 … 512. Raises where no band fits."""
    tall = -(-H // 8) * 8
    fits = []
    for cts in ((8, 4), (2, 1)):
        for rows in range(tall, 0, -8):
            for ct in cts:
                if ct <= _pow2_at_least(C) and chain3d_layout(H, W, ct, rows)[3] <= _SMEM_MAX:
                    fits.append((ct, rows))
        if fits:
            break
    if not fits:
        raise ValueError(f"dw_chain3d kernel: a band of 8 rows of width {W} "
                         "does not fit shared memory")
    grid = lambda ct, rows, runs=1: (-(-H // rows), -(-C // ct), B * 3 * runs)
    per_sm = lambda ct, rows: 2 if chain3d_layout(H, W, ct, rows)[3] <= _SMEM_TWO_BLOCKS else 1
    ct, rows = fits[0]
    if (ct == 8 and (4, rows) in fits
            and math.prod(grid(ct, rows)) < per_sm(ct, rows) * _SMS):
        ct = 4
    longest = -(-D // 3)
    runs = 1
    while (math.prod(grid(ct, rows, runs)) < per_sm(ct, rows) * _SMS
           and -(-longest // runs) > 1):
        runs += 1
    rhp, ring_chan, in_chan, smem = chain3d_layout(H, W, ct, rows)
    strips = ct * -(-min(rows, H) // _R7_3D) * W
    threads = min(512, max(128, -(-strips // 32) * 32))
    return LaunchPlan(ct, (rows,), _vec(ct, C), smem, grid(ct, rows, runs), threads,
                      _c_ints(B, D, H, W, C, ct, rows, runs, rhp, ring_chan, in_chan,
                              smem, threads),
                      parts=runs)


def chain2d_smem_bytes(W: int, rows: int, ct: int) -> int:
    """csrc/dw_chain2d.cu's shared memory for a band of `rows` output rows
    of `ct` channels: the haloed input rows (channel pitch padded to 4 mod
    8) and the dw5 rows ± 9 with their zero frame."""
    mrp = -(-(rows + 18) // _R5) * _R5
    in_chan = ((mrp + 4) * (W + 4) + 7) // 8 * 8 + 4
    return 4 * ct * (in_chan + mrp * (W + 18))


def _c_ints(*values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


@functools.lru_cache(maxsize=None)
def chain2d_plan(B: int, H: int, W: int, C: int) -> LaunchPlan:
    """dw_chain2d's blocks: bands of `rows` output rows (a multiple of the
    14-row strip) of `ct` channels of one image. Among the bands that keep
    two blocks per SM: tiles of 8 or 4 channels (16-byte vectors, 8 a whole
    32-byte sector per pixel) before narrower ones, then the tallest band
    (the fewest dw5 halo rows recomputed), and the first of these whose
    grid holds a wave of blocks; else one channel in the 227 KB a block
    may hold; raises where no band fits."""
    tall = -(-H // _R7) * _R7
    fits = []
    for cts in ((8, 4), (2, 1)):
        for rows in range(tall, 0, -_R7):
            for ct in cts:
                smem = chain2d_smem_bytes(W, rows, ct)
                if ct <= _pow2_at_least(C) and smem <= _SMEM_TWO_BLOCKS:
                    fits.append((ct, rows, smem))
    if not fits and chain2d_smem_bytes(W, _R7, 1) <= _SMEM_MAX:
        fits.append((1, _R7, chain2d_smem_bytes(W, _R7, 1)))
    if not fits:
        raise ValueError(f"dw_chain2d kernel: a band of {_R7} rows of width {W} "
                         "does not fit shared memory")
    grid = lambda ct, rows: (-(-H // rows), -(-C // ct), B)
    ct, rows, smem = next((f for f in fits if math.prod(grid(*f[:2])) >= _SMS), fits[0])
    # threads per channel: about two of its dilated strips (14 rows × 1
    # column) each, within 128 … 256 threads per block
    per_channel = _pow2_at_least(-(-(rows // _R7) * W // 2))
    threads = min(256, max(128, ct * per_channel))
    return LaunchPlan(ct, (rows,), _vec(ct, C), smem, grid(ct, rows), threads,
                      _c_ints(B, H, W, C, ct, rows, smem, threads))


def _chain2d_forward(x, w_dw, b_dw, w_dil, b_dil):
    B, H, W, C = x.shape
    dev = x.device
    if not (x.dtype is torch.float32 and x.is_contiguous()
            and _fits(w_dw, (5, 5, 1, C), dev) and _fits(b_dw, (C,), dev)
            and _fits(w_dil, (7, 7, 1, C), dev) and _fits(b_dil, (C,), dev)):
        for t, name, shape in ((x, "x", (B, H, W, C)), (w_dw, "w_dw", (5, 5, 1, C)),
                               (b_dw, "b_dw", (C,)), (w_dil, "w_dil", (7, 7, 1, C)),
                               (b_dil, "b_dil", (C,))):
            _require(t, name, shape, dev)
    plan = chain2d_plan(B, H, W, C)
    y = torch.empty_like(x)
    a = _pointers()
    a[0] = xp = x.data_ptr()
    a[1], a[2], a[3], a[4] = w_dw.data_ptr(), b_dw.data_ptr(), w_dil.data_ptr(), b_dil.data_ptr()
    a[5], a[6] = y.data_ptr(), _stream(dev)
    err = (_lib or library()).dlka_dw_chain2d(a, plan.params,
                                              plan.vec if xp % 16 == 0 else 1)
    if err:
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
    return _dispatch(_chain2d_forward, dw_chain2d_plain, x, w_dw, b_dw, w_dil, b_dil)


dw_chain2d.launches = 0

def dwconv3d_smem_bytes(D: int, H: int, W: int, K: int, dil: int, ct: int,
                        tile: tuple) -> int:
    """csrc/dwconv3d.cu's shared memory: the (K³, ct) weights and the
    tile's input with its halo h = dil·(K // 2), clipped to the volume
    along z and y, along x the tile rounded up to 4 plus 2h, made odd."""
    h = dil * (K // 2)
    TZ, TY, TX = tile
    sx = (-(-TX // 4) * 4 + 2 * h) | 1
    return 4 * ct * (K ** 3 + min(D, TZ + 2 * h) * min(H, TY + 2 * h) * sx)


@functools.lru_cache(maxsize=None)
def dwconv3d_plan(B: int, D: int, H: int, W: int, C: int, K: int,
                  dil: int) -> LaunchPlan:
    """dwconv3d's blocks: output tiles (TZ, TY, TX) of `ct` channels (up to
    8: a 32-byte sector per voxel) of one volume. From the whole volume, a
    tile side is halved (the one whose halving saves the most shared
    memory) until two blocks fit an SM, else fewer channels; then on while
    the grid holds less than a wave of blocks and the staged input stays
    under 8× the tile's; raises where one voxel of one channel does not
    fit the 227 KB a block may hold."""
    h = dil * (K // 2)

    def halved(tile, ct):
        cands = [tile[:i] + (-(-tile[i] // 2),) + tile[i + 1:]
                 for i in range(3) if tile[i] > 1]
        return min(cands, key=lambda t: dwconv3d_smem_bytes(D, H, W, K, dil, ct, t))

    def grid(tile, ct):
        return (-(-D // tile[0]) * -(-H // tile[1]) * -(-W // tile[2]), -(-C // ct), B)

    smem = lambda tile, ct: dwconv3d_smem_bytes(D, H, W, K, dil, ct, tile)
    for ct in (c for c in (8, 4, 2, 1) if c <= _pow2_at_least(C)):
        tile = (D, H, W)
        while smem(tile, ct) > _SMEM_TWO_BLOCKS and tile != (1, 1, 1):
            tile = halved(tile, ct)
        if smem(tile, ct) <= _SMEM_TWO_BLOCKS or (ct == 1 and smem(tile, ct) <= _SMEM_MAX):
            break
    else:
        raise ValueError(f"dwconv3d kernel: K={K} dil={dil} does not fit shared memory")
    while math.prod(grid(tile, ct)) < _SMS and tile != (1, 1, 1):
        half = halved(tile, ct)
        staged = (smem(half, ct) - 4 * ct * K ** 3) // (4 * ct)
        if staged > 8 * math.prod(half):
            break
        tile = half
    return LaunchPlan(ct, tile, _vec(ct, C), smem(tile, ct), grid(tile, ct), 256,
                      _c_ints(B, D, H, W, C, K, dil, ct, *tile, smem(tile, ct)))


def _dwconv3d_forward(x, w, bias, dil):
    B, D, H, W, C = x.shape
    dev = x.device
    K = w.shape[0]
    if not (K % 2 and dil >= 1 and x.dtype is torch.float32 and x.is_contiguous()
            and _fits(w, (K, K, K, 1, C), dev)  # cubic
            and (bias is None or _fits(bias, (C,), dev)) and B * D * H * W * C < 2 ** 31):
        if K % 2 == 0 or dil < 1:
            raise ValueError(f"dwconv3d kernel: a cubic odd kernel and dil >= 1 "
                             f"only, got w {tuple(w.shape)}, dil {dil}")
        _require(x, "x", (B, D, H, W, C), dev)
        _require(w, "w", (K, K, K, 1, C), dev)
        if bias is not None:
            _require(bias, "bias", (C,), dev)
        raise ValueError("dwconv3d kernel: too many elements for int32 indices")
    plan = dwconv3d_plan(B, D, H, W, C, K, dil)
    y = torch.empty_like(x)
    a = _pointers()
    a[0] = xp = x.data_ptr()
    a[1], a[2] = w.data_ptr(), 0 if bias is None else bias.data_ptr()
    a[3], a[4] = y.data_ptr(), _stream(dev)
    err = (_lib or library()).dlka_dwconv3d(a, plan.params,
                                            plan.vec if xp % 16 == 0 else 1)
    if err:
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
    if not (torch.is_grad_enabled() and (x.requires_grad or w.requires_grad or (
            bias is not None and bias.requires_grad))):  # `_grad_needed`, inlined
        return _dwconv3d_forward(x, w, bias, dil)
    if bias is None:
        return _PlainVjp.apply(lambda x, w: _dwconv3d_forward(x, w, None, dil),
                               lambda x, w: dwconv3d_plain(x, w, None, dil), x, w)
    return _PlainVjp.apply(lambda *t: _dwconv3d_forward(*t, dil),
                           lambda *t: dwconv3d_plain(*t, dil), x, w, bias)


dwconv3d.launches = 0

WRAPPERS = (deform_conv3d, dw_chain3d, deform_conv3d_bwd, deform_dw_conv2d,
            deform_dw_conv2d_bwd, dw_chain2d, dwconv3d)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    """{wrapper name: its launches since the last `reset_launches`}."""
    return {fn.__name__: fn.launches for fn in WRAPPERS}
