"""The launch plans of the 2D LKA chain kernel (`chain2d_plan`) and the
dilated 3D depthwise kernel (`dwconv3d_plan`), and the wrappers' lean
dispatch, on the CPU.

A plan is a pure function of the shape: the channel tile, the spatial
split, the vector width and the shared memory of each block, and the
grid. It is checked at every site shape of the two kernels (the three 2D
decoder shapes at batch 24; 8³×128 K5 d3 and 4³×256 K3 d2 at batch 8) and
at every shape of the `cuda` tests in `tests/test_torch_kernels.py`. The
dispatch runs with the plain version standing in for the kernel, as on the
card: exact equality (atol 0), since both sides run the same plain code.
"""

import math

import numpy as np
import pytest
import torch

from deformablelka_tpu_torch.ops import kernels
from deformablelka_tpu_torch.ops.dwconv3d import depthwise_conv3d_dilated
from deformablelka_tpu_torch.ops.lka import dw_chain2d

torch.set_num_threads(1)

SMEM_MAX = 232448   # shared memory one block may hold on an H100
SMS = 132

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
