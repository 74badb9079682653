"""The launch plans of the hand kernels, the wrappers' lean dispatch, and
the 3xTF32 split of the deform conv's channel mix, on the CPU.

A plan is a pure function of the shape: the channel tile, the spatial
split, the vector width and the shared memory of each block, and the
grid. It is checked at every site shape of its kernel (the 3D deform conv
and the 3D LKA chain at the four stage shapes, batch 8 for inference and 2
for training; the deform conv's backward at the four stage shapes, batch
2; the Pancreas model's four stage shapes at batch 2, as its trainer runs
them, for both deform kernels and the chain; the three 2D decoder shapes
at batch 24, the 2D deform conv and its backward at k5 and k7 dil 3 on
each, the backward also at batch 16, the skin trainer's; 8³×128 K5 d3 and
4³×256 K3 d2 at batch 8) and at every shape of the `cuda` tests in
`tests/test_torch_kernels.py`. The dispatch runs with the plain version
standing in for the kernel, as on the card: exact equality (atol 0), since
both sides run the same plain code; so does the 2D deform conv's autograd
Function, with the plain forward and backward standing in for its two
kernels.
"""

import math

import numpy as np
import pytest
import torch

from deformablelka_tpu_torch.ops import kernels
from deformablelka_tpu_torch.ops.deform2d import deform_dw_conv2d, deform_dw_conv2d_backward
from deformablelka_tpu_torch.ops.dwconv3d import depthwise_conv3d_dilated
from deformablelka_tpu_torch.ops.lka import dw_chain2d

torch.set_num_threads(1)

SMEM_MAX = 232448   # shared memory one block may hold on an H100
SMS = 132

STAGES_3D = [(32, 32), (16, 64), (8, 128), (4, 256)]   # (side, channels)
DEFORM_SITES = [(B, S, S, S, C, C) for B in (8, 2) for S, C in STAGES_3D]
# the Pancreas model's stages at its 96³ patch, batch 2 as its trainer runs
# them (forward and backward)
PANCREAS_STAGES = [(48, 32), (24, 64), (12, 128), (6, 256)]
PANCREAS_SITES = [(2, S, S, S, C, C) for S, C in PANCREAS_STAGES]
DEFORM_TESTS = [(1, 3, 5, 7, 5, 3), (2, 6, 4, 9, 40, 70), (2, 5, 7, 9, 36, 20),
                (1, 4, 6, 5, 6, 10), (3, 9, 10, 11, 64, 96), (1, 4, 5, 6, 8, 8),
                (4, 4, 4, 4, 8, 8)]
CHAIN3D_SITES = [(B, S, S, S, C) for B in (8, 2) for S, C in STAGES_3D]
CHAIN3D_TESTS = [(1, 5, 13, 7, 3), (2, 20, 11, 30, 6), (1, 7, 40, 24, 8),
                 (1, 9, 50, 12, 5), (1, 4, 5, 6, 8), (2, 4, 4, 4, 8),
                 *[(2, S, S, S, C) for S, C in PANCREAS_STAGES]]
CHAIN_SITES = [(24, 14, 14, 384), (24, 28, 28, 192), (24, 56, 56, 96)]
CHAIN_TESTS = [(1, 5, 7, 3), (2, 20, 31, 6), (1, 100, 90, 2), (1, 200, 200, 1),
               (2, 33, 10, 12), (2, 64, 64, 96), (4, 56, 56, 96), (2, 14, 12, 32)]
DW_SITES = [(8, 8, 8, 8, 128, 5, 3), (8, 4, 4, 4, 256, 3, 2)]
DW_TESTS = [(2, 10, 14, 22, 8, 7, 3), (1, 4, 4, 4, 32, 5, 3), (2, 5, 9, 6, 40, 3, 1),
            (1, 9, 10, 11, 3, 5, 2), (2, 6, 7, 13, 12, 3, 1), (2, 8, 8, 8, 128, 5, 3),
            (1, 20, 24, 28, 16, 5, 3)]


def _check_common(plan, C):
    assert plan.smem_bytes <= SMEM_MAX
    ct = plan.channel_tile
    assert ct & (ct - 1) == 0 and ct <= 32
    assert plan.grid[1] * ct >= C > (plan.grid[1] - 1) * ct  # the tiles cover C
    if plan.vec == 4:
        assert C % 4 == 0 and ct % 4 == 0
    else:
        assert plan.vec == 1


def _ids(shapes):
    return ["x".join(map(str, s)) for s in shapes]


@pytest.mark.parametrize("shape", DEFORM_SITES + PANCREAS_SITES + DEFORM_TESTS,
                         ids=_ids(DEFORM_SITES + PANCREAS_SITES + DEFORM_TESTS))
def test_deform3d_plan(shape):
    B, D, H, W, Ci, Co = shape
    plan = kernels.deform3d_plan(*shape)
    assert plan.smem_bytes <= SMEM_MAX
    rows = 64  # csrc/deform3d.cu kRows
    assert plan.smem_bytes == kernels.deform3d_smem_bytes(rows, plan.channel_tile,
                                                          list(plan.params)[11])
    assert plan.channel_tile == (32 if Co <= 32 else 64)
    assert plan.threads == 128
    # the brick: powers of two, at most `rows` voxels; the grid covers every
    # voxel of every volume and every output channel
    assert all(t & (t - 1) == 0 for t in plan.tile) and math.prod(plan.tile) <= rows
    bricks = math.prod(-(-S // t) for S, t in zip((D, H, W), plan.tile))
    assert plan.grid[0] == B * bricks
    bn = plan.channel_tile
    assert plan.grid[1] * bn >= Co > (plan.grid[1] - 1) * bn
    # K over taps: `parts` runs of `taps` taps cover the 27, none empty
    parts, taps = plan.grid[2], list(plan.params)[11]
    assert parts == plan.parts and parts * taps >= 27 > (parts - 1) * taps
    lz, ly, lx = list(plan.params)[7:10]
    assert plan.tile == (1 << lz, 1 << ly, 1 << lx)
    assert list(plan.params) == [B, D, H, W, Ci, Co, bn, lz, ly, lx, parts, taps,
                                 plan.smem_bytes]
    assert plan.vec == (4 if Ci % 4 == 0 and Co % 4 == 0 else 1)
    if shape in DEFORM_SITES + PANCREAS_SITES:
        assert math.prod(plan.grid) >= SMS
        assert plan.vec == 4
        assert plan.smem_bytes <= SMEM_MAX // 2  # two blocks per SM


def test_deform3d_plan_splits_k_only_where_the_tiles_leave_sms_idle():
    """At batch 8 the 32³ and 16³ stages fill the card with voxel tiles
    alone (three blocks per SM); the 8³ and 4³ stages split K over taps."""
    plans = [kernels.deform3d_plan(8, S, S, S, C, C) for S, C in STAGES_3D]
    assert [p.parts for p in plans[:2]] == [1, 1]
    assert plans[2].parts > 1 and plans[3].parts > 1
    for plan in plans:
        assert (plan.parts == 1) == (math.prod(plan.grid[:2]) >= 3 * SMS)


BWD_SITES = [(2, S, S, S, C, C) for S, C in STAGES_3D]
BWD_TESTS = [(1, 3, 5, 7, 5, 3), (2, 6, 4, 9, 40, 70), (2, 9, 10, 11, 64, 96),
             (1, 5, 6, 7, 36, 20), (1, 13, 3, 6, 33, 7), (1, 5, 6, 7, 12, 12),
             (2, 4, 5, 6, 8, 8), (2, 6, 7, 5, 16, 16)]


@pytest.mark.parametrize("shape", BWD_SITES + PANCREAS_SITES + BWD_TESTS,
                         ids=_ids(BWD_SITES + PANCREAS_SITES + BWD_TESTS))
def test_deform3d_bwd_plan(shape):
    B, D, H, W, Ci, Co = shape
    plan = kernels.deform3d_bwd_plan(*shape)
    p = list(plan.params)
    lz, ly, lx, chunks, groups, taps, T, parts, per_part = p[6:]
    assert p[:6] == [B, D, H, W, Ci, Co]
    # the data launch: bricks of at most 64 voxels cover every volume, 32
    # input channels a block, taps in groups that cover the 27, none empty
    assert plan.tile == (1 << lz, 1 << ly, 1 << lx) and math.prod(plan.tile) <= 64
    bricks = B * math.prod(-(-n // t) for n, t in zip((D, H, W), plan.tile))
    assert plan.grid == (bricks, chunks, groups) and plan.threads == 256
    assert plan.channel_tile == 32 and chunks * 32 >= Ci > (chunks - 1) * 32
    assert groups in (1, 3, 9, 27) and groups * taps == 27
    # static shared memory only: the data kernel's fixed layout is held
    # to 48 KB by a static_assert in csrc/deform3d_bwd.cu
    assert plan.smem_bytes == 0
    # the weight GEMM: whole 32-voxel steps a part, the parts cover the voxels
    n = B * D * H * W
    assert T == (32 if Ci <= 32 and Co <= 32 else 64)
    assert per_part % 32 == 0 and parts * per_part >= n > (parts - 1) * per_part
    assert parts == 1 or per_part >= 4 * 32
    assert plan.parts == parts
    assert plan.vec == (4 if Ci % 4 == 0 and Co % 4 == 0 else 1)
    if shape in BWD_SITES + PANCREAS_SITES:
        assert plan.vec == 4
        assert math.prod(plan.grid) >= 8 * SMS or groups == 27
        gemm_warps = -(-Ci // T) * -(-Co // T) * 27 * parts * (T // 4) ** 2 // 32
        assert gemm_warps >= (16 if T == 32 else 32) * SMS or parts == max(1, -(-n // 32) // 4)


def test_deform3d_bwd_plan_splits_taps_only_where_bricks_leave_sms_idle():
    """At batch 2 the 32³ stage fills the card (eight blocks per SM) with
    bricks in 3 tap groups, 16³ in 9; 8³ and 4³ give each tap its own
    block."""
    plans = [kernels.deform3d_bwd_plan(*s) for s in BWD_SITES]
    assert [p.grid[2] for p in plans] == [3, 9, 27, 27]


D2D_SITES = [(24, S, S, C, k, dil) for _, S, _, C in CHAIN_SITES for k, dil in ((5, 1), (7, 3))]
D2D_TESTS = [(24, 14, 14, 384, 7, 3), (4, 56, 56, 96, 5, 1), (4, 56, 56, 96, 7, 3),
             (1, 9, 13, 5, 5, 1), (2, 7, 5, 40, 7, 3), (1, 10, 12, 33, 3, 2),
             (2, 3, 30, 36, 5, 1), (1, 37, 2, 6, 7, 3), (2, 9, 11, 8, 5, 1),
             (2, 14, 12, 32, 5, 1), (2, 14, 12, 32, 7, 3), (2, 6, 6, 8, 5, 1)]


@pytest.mark.parametrize("shape", D2D_SITES + D2D_TESTS, ids=_ids(D2D_SITES + D2D_TESTS))
def test_deform2d_dw_plan(shape):
    B, H, W, C, k, dil = shape
    plan = kernels.deform2d_dw_plan(*shape)
    th, tw = plan.tile
    assert 4 <= tw <= 16 and th == 32 // tw
    # no tile of 4 … 16 columns leaves fewer of its pixels outside the image
    idle = lambda tw: ((-(-H // (32 // tw)) * (32 // tw) * -(-W // tw) * tw - H * W)
                       / (32 // tw * tw))
    assert idle(tw) == min(idle(t) for t in range(4, 17))
    cpp = plan.channel_tile
    assert cpp % 32 == 0 and plan.grid[1] * cpp >= C > (plan.grid[1] - 1) * cpp
    assert plan.grid == (B * -(-H // th) * -(-W // tw), plan.grid[1], 1)
    assert plan.smem_bytes == k * k * (th * tw * 16 + 32 * 4) <= SMEM_MAX
    assert plan.threads == 256
    assert list(plan.params) == [B, H, W, C, k, dil, th, tw, cpp, plan.smem_bytes]
    assert plan.vec == (4 if C % 4 == 0 else 1)
    if shape in D2D_SITES:
        assert plan.vec == 4
        assert math.prod(plan.grid) >= 3 * SMS
        assert 4 * (plan.smem_bytes + 1024) <= 233472  # four blocks per SM
        assert -(-H // th) * th == H and -(-W // tw) * tw == W  # no idle pixel


D2D_BWD_SITES = D2D_SITES + [(16, S, S, C, k, dil) for _, S, _, C in CHAIN_SITES
                             for k, dil in ((5, 1), (7, 3))]
D2D_BWD_TESTS = [(2, 14, 14, 384, 5, 1), (2, 14, 14, 384, 7, 3), (2, 28, 28, 192, 7, 3),
                 (2, 56, 56, 96, 5, 1), (2, 56, 56, 96, 7, 3), (1, 9, 13, 5, 5, 1),
                 (2, 7, 5, 40, 7, 3), (1, 10, 12, 33, 3, 2), (2, 3, 30, 36, 5, 1),
                 (1, 37, 2, 6, 7, 3), (2, 9, 11, 8, 5, 1), (4, 28, 28, 192, 7, 3),
                 (2, 14, 12, 32, 7, 3)]


@pytest.mark.parametrize("shape", D2D_BWD_SITES + D2D_BWD_TESTS,
                         ids=_ids(D2D_BWD_SITES + D2D_BWD_TESTS))
def test_deform2d_dw_bwd_plan(shape):
    """The block's shared memory fits at every site and test shape; the
    grid covers the image (tiles of 8 … 64 pixels, no side past the
    image's) and the channels (chunks of 32·nq, nq = ⌈C / 32⌉ up to 3); k
    warps a tap row times the splits, up to 768 threads."""
    B, H, W, C, k, dil = shape
    plan = kernels.deform2d_dw_bwd_plan(*shape)
    th, tw = plan.tile
    splits, nq, smem = list(plan.params)[8:]
    assert list(plan.params)[:8] == [B, H, W, C, k, dil, th, tw]
    assert plan.smem_bytes == smem == kernels.deform2d_dw_bwd_smem_bytes(
        th, tw, k, splits, nq) <= SMEM_MAX
    assert 1 <= th <= H and 1 <= tw <= W and min(8, H * W) <= th * tw <= 64
    assert plan.grid == (B * -(-H // th) * -(-W // tw), -(-C // (32 * nq)), 1)
    assert nq == min(3, -(-C // 32)) and plan.channel_tile == 32 * nq
    assert (plan.grid[1] - 1) * plan.channel_tile < C <= plan.grid[1] * plan.channel_tile
    assert plan.parts == plan.grid[1]
    assert plan.threads == 32 * k * splits <= 768 and (splits == 1 or th * tw // splits >= 16)
    assert plan.vec == (4 if C % 4 == 0 else 1)
    if shape in D2D_BWD_SITES:
        assert plan.vec == 4 and nq == 3
        # dw's per-tile parts fit int32 indices
        assert plan.grid[0] * k * k * C < 2 ** 31
        # at least 16 warps on an SM (80 registers a thread, the data kernel's)
        blocks = min(2048 // plan.threads, 65536 // (80 * plan.threads),
                     (SMEM_MAX + 1024) // (plan.smem_bytes + 1024))
        assert blocks * plan.threads // 32 >= 16


def _deform_dw_inputs(seed=0, B=2, H=7, W=9, C=6, k=5):
    rng = np.random.RandomState(seed)
    off = rng.uniform(-2.5, 2.5, (B, H, W, 2 * k * k))
    off = np.where(rng.rand(*off.shape) < 0.25, np.round(off), off)
    return [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.randn(B, H, W, C), off, rng.randn(k, k, 1, C) / k, rng.randn(B, H, W, C))]


@pytest.mark.parametrize("dil", [1, 3])
def test_deform_dw_autograd_function_runs_the_backward_wrapper(monkeypatch, dil):
    """`_DeformDw2d`: forward through `_deform_dw_forward`, backward through
    `deform_dw_conv2d_bwd` with the saved inputs, g and the dilation; with
    the plain versions standing in for the two kernels, autograd's
    gradients exactly."""
    calls = []
    monkeypatch.setattr(kernels, "_deform_dw_forward",
                        lambda *a: calls.append("fwd") or deform_dw_conv2d(*a))
    monkeypatch.setattr(kernels, "deform_dw_conv2d_bwd",
                        lambda *a: calls.append("bwd") or deform_dw_conv2d_backward(*a))
    x, off, w, g = _deform_dw_inputs(seed=dil)
    leaves = [t.clone().requires_grad_() for t in (x, off, w)]
    kernels._DeformDw2d.apply(*leaves, dil).backward(g)
    assert calls == ["fwd", "bwd"]
    for t, r in zip(leaves, deform_dw_conv2d_backward(x, off, w, g, dil)):
        torch.testing.assert_close(t.grad, r, rtol=0, atol=0)


def test_deform_dw_backward_wrapper_on_cpu_tensors_is_plain():
    before = kernels.deform_dw_conv2d_bwd.launches
    x, off, w, g = _deform_dw_inputs(seed=4)
    for a, r in zip(kernels.deform_dw_conv2d_bwd(x, off, w, g, 3),
                    deform_dw_conv2d_backward(x, off, w, g, 3)):
        assert torch.equal(a, r)
    assert kernels.deform_dw_conv2d_bwd.launches == before


@pytest.mark.parametrize("shape", CHAIN3D_SITES + CHAIN3D_TESTS,
                         ids=_ids(CHAIN3D_SITES + CHAIN3D_TESTS))
def test_chain3d_plan(shape):
    B, D, H, W, C = shape
    plan = kernels.chain3d_plan(*shape)
    _check_common(plan, C)
    rows, = plan.tile
    p = list(plan.params)
    ct, runs, rhp, ring_chan, in_chan, smem, threads = p[5], *p[7:]
    assert p[:7] == [B, D, H, W, C, plan.channel_tile, rows]
    assert plan.grid[0] * rows >= H > (plan.grid[0] - 1) * rows
    assert plan.grid[2] == B * 3 * runs and runs == plan.parts
    # the runs cover the longest z phase, none empty
    longest = -(-D // 3)
    per_run = -(-longest // runs)
    assert runs * per_run >= longest > (runs - 1) * per_run
    # every band's rows ± 9 inside the volume fit the ring; the staged plane
    # holds the ring's rows ± 2 and the band's output rows
    for r0 in range(0, H, rows):
        assert min(H, r0 + rows + 9) - max(0, r0 - 9) <= rhp
    assert rhp >= 8 and ring_chan >= (rhp + 1) * (W + 1)
    assert in_chan >= (rhp + 4) * (W + 4) and in_chan >= max(rows, 8) * W
    assert smem == plan.smem_bytes == 4 * ct * (7 * ring_chan + in_chan)
    assert kernels.chain3d_layout(H, W, ct, rows) == (rhp, ring_chan, in_chan, smem)
    assert threads == plan.threads and threads % 32 == 0 and 128 <= threads <= 512
    if W < 32:  # a warp's lanes along x, then across channels, on distinct banks
        assert ring_chan % 32 == W and in_chan % 32 == W
    if shape in CHAIN3D_SITES:
        assert math.prod(plan.grid) >= SMS
        assert plan.vec == 4
        assert rows >= H  # whole planes: no dw5 halo rows recomputed


@pytest.mark.parametrize("shape", CHAIN_SITES + CHAIN_TESTS,
                         ids=["x".join(map(str, s)) for s in CHAIN_SITES + CHAIN_TESTS])
def test_chain2d_plan(shape):
    B, H, W, C = shape
    plan = kernels.chain2d_plan(*shape)
    _check_common(plan, C)
    rows, = plan.tile
    assert rows % 14 == 0 and plan.grid[0] * rows >= H > (plan.grid[0] - 1) * rows
    assert plan.grid[2] == B
    assert plan.smem_bytes == kernels.chain2d_smem_bytes(W, rows, plan.channel_tile)
    assert plan.threads & (plan.threads - 1) == 0
    assert plan.channel_tile <= plan.threads <= 256
    assert list(plan.params) == [B, H, W, C, plan.channel_tile, rows, plan.smem_bytes,
                                 plan.threads]
    if shape in CHAIN_SITES:
        assert math.prod(plan.grid) >= SMS
        assert plan.vec == 4
        assert plan.smem_bytes <= SMEM_MAX // 2  # two blocks per SM


@pytest.mark.parametrize("shape", DW_SITES + DW_TESTS,
                         ids=["x".join(map(str, s)) for s in DW_SITES + DW_TESTS])
def test_dwconv3d_plan(shape):
    B, D, H, W, C, K, dil = shape
    plan = kernels.dwconv3d_plan(*shape)
    _check_common(plan, C)
    tiles = [-(-S // T) for S, T in zip((D, H, W), plan.tile)]
    assert plan.grid == (math.prod(tiles), plan.grid[1], B)
    assert plan.smem_bytes == kernels.dwconv3d_smem_bytes(D, H, W, K, dil,
                                                          plan.channel_tile, plan.tile)
    assert list(plan.params) == [B, D, H, W, C, K, dil, plan.channel_tile,
                                 *plan.tile, plan.smem_bytes]
    if shape in DW_SITES:
        assert math.prod(plan.grid) >= SMS
        assert plan.vec == 4


def test_plans_raise_where_nothing_fits():
    with pytest.raises(ValueError):
        kernels.chain2d_plan(1, 14, 2000, 1)   # 14 rows of 2000 columns
    with pytest.raises(ValueError):
        kernels.chain3d_plan(1, 4, 30, 1000, 1)  # 7 planes of 27 rows of 1000 columns
    with pytest.raises(ValueError):
        kernels.dwconv3d_plan(1, 8, 8, 8, 1, 41, 1)  # 41³ weights alone: 276 KB


def _chain_inputs(seed=0, B=2, H=9, W=11, C=5):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.randn(B, H, W, C), rng.randn(5, 5, 1, C) / 5, rng.randn(C),
        rng.randn(7, 7, 1, C) / 7, rng.randn(C))]


def _dw_inputs(seed=0):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.randn(2, 4, 5, 6, 8), rng.randn(3, 3, 3, 1, 8) / 5, rng.randn(8))]


CASES = {"chain2d": (dw_chain2d, _chain_inputs),
         "dwconv3d": (lambda *t: depthwise_conv3d_dilated(*t, 2), _dw_inputs)}


@pytest.mark.parametrize("name", list(CASES))
def test_dispatch_without_grad_launches_the_forward_alone(name):
    """Under `no_grad`, or when no input requires a gradient, the forward
    runs with no autograd Function around it."""
    plain, inputs = CASES[name]
    args = inputs()
    calls = []
    kernel = lambda *t: calls.append(1) or plain(*t)
    with torch.no_grad():
        leaves = [a.clone().requires_grad_() for a in args]
        y = kernels._dispatch(kernel, plain, *leaves)
    assert y.grad_fn is None
    torch.testing.assert_close(y, plain(*args), rtol=0, atol=0)
    y = kernels._dispatch(kernel, plain, *args)
    assert y.grad_fn is None and not y.requires_grad
    assert len(calls) == 2


@pytest.mark.parametrize("name", list(CASES))
def test_dispatch_with_grad_gives_the_plain_gradient(name):
    plain, inputs = CASES[name]
    args = inputs(seed=1)
    need = [True, False] + [True] * (len(args) - 2)  # one weight frozen
    gy = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(3))

    def grads(fn):
        leaves = [a.clone().requires_grad_(n) for a, n in zip(args, need)]
        y = fn(*leaves)
        assert y.grad_fn is not None
        y.backward(gy)
        return [t.grad for t in leaves]

    got = grads(lambda *t: kernels._dispatch(plain, plain, *t))
    ref = grads(plain)
    for g, r, n in zip(got, ref, need):
        if n:
            torch.testing.assert_close(g, r, rtol=0, atol=0)
        else:
            assert g is None and r is None


def test_grad_needed():
    x = torch.zeros(2)
    assert not kernels._grad_needed(x, None)
    assert kernels._grad_needed(x, None, x.clone().requires_grad_())
    with torch.no_grad():
        assert not kernels._grad_needed(x.clone().requires_grad_())


def test_wrappers_on_cpu_tensors_stay_plain_and_launch_nothing():
    before = (kernels.dw_chain2d.launches, kernels.dwconv3d.launches)
    args = _chain_inputs(seed=2)
    assert torch.equal(kernels.dw_chain2d(*args), dw_chain2d(*args))
    x, w, b = _dw_inputs(seed=2)
    assert torch.equal(kernels.dwconv3d(x, w, b, 2), depthwise_conv3d_dilated(x, w, b, 2))
    assert (kernels.dw_chain2d.launches, kernels.dwconv3d.launches) == before


def _tf32(a):
    """cvt.rna.tf32.f32: round to the nearest value with a 10-bit mantissa,
    ties away from zero (the 13 dropped bits of an f32)."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _mma_sum(pairs, K):
    """Σ over k of the products of each (A, B) pair, as the tensor cores
    take it: each m16n8k8 product exact, added into an f32 accumulator."""
    acc = np.zeros((pairs[0][0].shape[0], pairs[0][1].shape[1]), np.float32)
    for k0 in range(0, K, 8):
        for a, b in pairs:
            part = a[:, k0:k0 + 8].astype(np.float64) @ b[k0:k0 + 8].astype(np.float64)
            acc = (acc + part).astype(np.float32)
    return acc


@pytest.mark.parametrize("seed", [0, 1])
def test_3xtf32_split_meets_the_kernel_tolerance_where_one_tf32_product_does_not(seed):
    """Why csrc/deform3d.cu splits each operand into TF32 high and low
    parts: at the 4³×256 stage, K = 27·256, the three-product sum is held
    to chip_smoke.py's REL_TOL = 1e-4 · max(1, max|exact|) with room to
    spare, and one TF32 product alone is not. Operands as the kernel sees
    them: blended samples ~ N(0, 1), weights ~ N(0, 1/K)."""
    K = 27 * 256
    rng = np.random.RandomState(seed)
    a = rng.randn(64, K).astype(np.float32)
    b = (rng.randn(K, 32) / np.sqrt(K)).astype(np.float32)
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    # hi + lo restores an operand to 2^-22 of itself
    for x, hi, lo in ((a, a_hi, a_lo), (b, b_hi, b_lo)):
        assert np.all(np.abs(hi.astype(np.float64) + lo - x) <= 2.0 ** -22 * np.abs(x))
    exact = a.astype(np.float64) @ b.astype(np.float64)
    tol = 1e-4 * max(1.0, np.abs(exact).max())
    three = _mma_sum([(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)], K)
    one = _mma_sum([(a_hi, b_hi)], K)
    assert np.abs(three - exact).max() <= tol / 10
    assert np.abs(one - exact).max() > tol
