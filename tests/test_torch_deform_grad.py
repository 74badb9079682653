"""The gradients of the port's deform conv and 3D LKA chain against the
JAX package's, on the CPU in float32, and the autograd wrappers of the
hand kernels.

`ops.deform3d.deform_conv3d_backward` (autograd of the plain forward; the
CUDA backward kernel is held against it on the card) is held against:

- `jax.vjp` of the JAX gather form at offsets uniform in ±2.5, where many
  corners fall outside the volume;
- the JAX default dispatch (`deformablelka_tpu.ops.deform_conv3d`, hybrid:
  the R=1 window with its own VJP) and the TPU backward kernel
  `deform_conv3d_window_bwd_pallas` in interpret mode, at non-integer
  |Δ| < 1, where its clip is lossless and its zero derivative at integer
  offsets is never met.

Tolerance, as the JAX package's own test of its backward kernel
(tests/test_deform_ops.py): atol/rtol 2e-5 for dx and d-offset, 2e-4 for
dw (a sum over every voxel).

`ops.lka.dw_chain3d_backward` (the chain's gradient written out, the CPU
path of the chain's backward kernel and the form that kernel computes) is
held against `jax.vjp` of the TPU chain kernel in interpret mode (its VJP
is `_c3_bwd`'s, the plain form's) and of the XLA chain, and against torch
autograd of the plain chain, each of the five gradients to
1e-5 · max(1, max|ref|): f32 sums in another order (measured: ≤ 1.3e-6).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deformablelka_tpu import ops as jops
from deformablelka_tpu.ops import deform_conv3d_gather
from deformablelka_tpu.ops import lka as jlka
from deformablelka_tpu.ops.pallas.deform3d_bwd_kernel import (
    deform_conv3d_window_bwd_pallas)
from deformablelka_tpu.ops.pallas.lka_fused_kernel import dw_chain3d_fused
from deformablelka_tpu_torch.ops import kernels
from deformablelka_tpu_torch.ops.deform3d import deform_conv3d_backward
from deformablelka_tpu_torch.ops.lka import dw_chain3d, dw_chain3d_backward

torch.set_num_threads(1)
TOL = {"dx": 2e-5, "doff": 2e-5, "dw": 2e-4}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(seed, shape, C, cout, amp):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape, C).astype(np.float32)
    off = rng.uniform(-amp, amp, shape + (81,)).astype(np.float32)
    w = (rng.randn(3, 3, 3, C, cout) / np.sqrt(27 * C)).astype(np.float32)
    g = rng.randn(*shape, cout).astype(np.float32)
    return x, off, w, g


def _assert_grads(got, ref):
    for name, a, r in zip(("dx", "doff", "dw"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=TOL[name],
                                   rtol=TOL[name], err_msg=name)


@pytest.mark.parametrize("shape,C,cout", [((2, 4, 6, 5), 4, 4),
                                          ((1, 5, 5, 5), 8, 6),
                                          ((1, 3, 4, 4), 32, 32)])
def test_plain_backward_matches_gather_vjp_past_the_border(shape, C, cout):
    x, off, w, g = _inputs(0, shape, C, cout, 2.5)
    assert (np.abs(off) > 1).mean() > 0.5

    def f(x, off, w):
        return deform_conv3d_gather(x, off, w, None, stride=1, padding=1,
                                    dilation=1)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (x, off, w)))
    _assert_grads(deform_conv3d_backward(*map(_t, (x, off, w, g))),
                  vjp(jnp.asarray(g)))


@pytest.mark.parametrize("shape,C", [((1, 4, 8, 8), 8), ((2, 8, 16, 8), 4)])
def test_plain_backward_matches_window_vjp_and_pallas_backward(shape, C):
    """At non-integer |Δ| < 1 the JAX default (hybrid → R=1 window VJP) and
    the TPU backward kernel (interpret mode) give the exact gradient."""
    x, off, w, g = _inputs(1, shape, C, C, 0.95)
    got = deform_conv3d_backward(*map(_t, (x, off, w, g)))

    def f(x, off, w):
        return jops.deform_conv3d(x, off, w, None, stride=1, padding=1,
                                  dilation=1)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (x, off, w)))
    _assert_grads(got, vjp(jnp.asarray(g)))
    _assert_grads(got, deform_conv3d_window_bwd_pallas(
        *map(jnp.asarray, (x, off, w, g)), interpret=True))


def test_deform_wrapper_on_cpu_gives_the_plain_gradients():
    """On a CPU tensor autograd differentiates the plain forward; the bias
    gradient is Σg."""
    x, off, w, g = map(_t, _inputs(2, (1, 4, 5, 3), 6, 5, 2.0))
    b = torch.randn(5, generator=torch.Generator().manual_seed(0))
    leaves = [t.clone().requires_grad_() for t in (x, off, w, b)]
    kernels.deform_conv3d(*leaves).backward(g)
    ref = deform_conv3d_backward(x, off, w, g)
    for leaf, r in zip(leaves, ref):
        torch.testing.assert_close(leaf.grad, r, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(leaves[3].grad, g.sum((0, 1, 2, 3)))
    for a, r in zip(kernels.deform_conv3d_bwd(x, off, w, g), ref):
        torch.testing.assert_close(a, r)
    assert kernels.deform_conv3d_bwd.launches == 0


def test_deform_function_backward_plumbing():
    """The autograd.Function's backward, run on CPU tensors (where
    `deform_conv3d_bwd` is the plain backward): a non-contiguous cotangent,
    the bias gradient Σg, and no bias gradient without a bias."""
    x, off, w, g = map(_t, _inputs(3, (2, 3, 4, 5), 4, 7, 1.5))
    g_nc = g.permute(0, 2, 1, 3, 4).contiguous().permute(0, 2, 1, 3, 4)
    assert not g_nc.is_contiguous()
    ctx = SimpleNamespace(saved_tensors=(x, off, w), has_bias=True)
    dx, doff, dw, db = kernels._DeformConv3d.backward(ctx, g_nc)
    for a, r in zip((dx, doff, dw), deform_conv3d_backward(x, off, w, g)):
        torch.testing.assert_close(a, r)
    torch.testing.assert_close(db, g.sum((0, 1, 2, 3)))
    ctx.has_bias = False
    assert kernels._DeformConv3d.backward(ctx, g)[3] is None


def _chain_close(got, ref, name=""):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max()
    assert err <= 1e-5 * max(1.0, np.abs(ref).max()), (name, err)


def test_chain_function_backward_is_the_plain_vjp():
    """The chain's backward (`_Chain3d.backward`; on CPU tensors the plain
    backward, on the card the backward kernel) gives the VJP of the plain
    chain (two depthwise convs) for the inputs that need a gradient, as JAX
    `_c3_bwd`, from a non-contiguous cotangent, and None for the rest."""
    rng = np.random.RandomState(4)
    C = 5
    args = [_t(rng.randn(*s).astype(np.float32)) for s in
            ((2, 4, 6, 5, C), (5, 5, 5, 1, C), (C,), (7, 7, 7, 1, C), (C,))]
    g = _t(rng.randn(2, 4, 6, 5, C).astype(np.float32))
    g_nc = g.permute(0, 2, 1, 3, 4).contiguous().permute(0, 2, 1, 3, 4)
    assert not g_nc.is_contiguous()
    need = (True, True, False, True, True)
    ctx = SimpleNamespace(saved_tensors=tuple(args), needs_input_grad=need)
    got = kernels._Chain3d.backward(ctx, g_nc)
    leaves = [a.clone().requires_grad_(n) for a, n in zip(args, need)]
    ref = torch.autograd.grad(dw_chain3d(*leaves), [l for l in leaves if l.requires_grad], g)
    assert len(got) == 5 and got[2] is None
    for a, r in zip([a for a in got if a is not None], ref):
        torch.testing.assert_close(a, r)


CHAIN_NAMES = ("dx", "dw_dw", "db_dw", "dw_dil", "db_dil")


def _chain_case(shape, C, seed=0):
    rng = np.random.RandomState(seed)
    args = [rng.randn(*shape, C).astype(np.float32),
            (rng.randn(5, 5, 5, 1, C) * 0.1).astype(np.float32),
            rng.randn(C).astype(np.float32),
            (rng.randn(7, 7, 7, 1, C) * 0.05).astype(np.float32),
            rng.randn(C).astype(np.float32)]
    return args, rng.randn(*shape, C).astype(np.float32)


@pytest.mark.parametrize("reference", ["pallas_interpret", "xla", "torch_autograd"])
@pytest.mark.parametrize("shape,C", [((2, 4, 4, 4), 8), ((1, 6, 9, 7), 5),
                                     ((2, 12, 10, 11), 3)])
def test_plain_chain_backward_matches_the_references(shape, C, reference):
    """The chain's gradient written out, at a 4³ map (every border thinner
    than the dilated reach of 9), at C % 4 ≠ 0 and at a map whose interior
    planes the dilated taps reach from both sides, against `jax.vjp` of the
    TPU kernel (interpret mode) and of the XLA chain, and torch autograd of
    the plain chain: each of the five gradients."""
    args, g = _chain_case(shape, C)
    got = dw_chain3d_backward(*map(_t, args), _t(g))
    if reference == "torch_autograd":
        leaves = [_t(a).requires_grad_() for a in args]
        ref = torch.autograd.grad(dw_chain3d(*leaves), leaves, _t(g))
    else:
        fn = ((lambda *a: dw_chain3d_fused(*a, interpret=True))
              if reference == "pallas_interpret" else jlka.dw_chain3d)
        _, vjp = jax.vjp(fn, *map(jnp.asarray, args))
        ref = vjp(jnp.asarray(g))
    for name, a, r in zip(CHAIN_NAMES, got, ref):
        assert tuple(a.shape) == tuple(r.shape), name
        _chain_close(a.numpy(), r, name)


def test_chain_wrappers_on_cpu_give_the_plain_gradients():
    """On CPU tensors autograd differentiates the plain chain and the
    backward wrapper is the plain backward; neither launches anything."""
    args, g = _chain_case((1, 5, 4, 6), 4, seed=1)
    args, g = list(map(_t, args)), _t(g)
    before = (kernels.dw_chain3d.launches, kernels.dw_chain3d_bwd.launches)
    leaves = [a.clone().requires_grad_() for a in args]
    kernels.dw_chain3d(*leaves).backward(g)
    got = kernels.dw_chain3d_bwd(*args, g)
    for leaf, a, r in zip(leaves, got, dw_chain3d_backward(*args, g)):
        assert torch.equal(a, r)
        _chain_close(leaf.grad.numpy(), r.numpy())
    assert (kernels.dw_chain3d.launches, kernels.dw_chain3d_bwd.launches) == before
