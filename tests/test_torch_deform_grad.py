"""The gradient of the port's deform conv against the JAX package's, on the
CPU in float32, and the autograd wrappers of the hand kernels.

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
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deformablelka_tpu import ops as jops
from deformablelka_tpu.ops import deform_conv3d_gather
from deformablelka_tpu.ops.pallas.deform3d_bwd_kernel import (
    deform_conv3d_window_bwd_pallas)
from deformablelka_tpu_torch.ops import kernels
from deformablelka_tpu_torch.ops.deform3d import deform_conv3d_backward
from deformablelka_tpu_torch.ops.lka import dw_chain3d

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


def test_chain_function_backward_is_the_plain_vjp():
    """The chain's backward recomputes the VJP of the plain chain (two
    depthwise convs) for the inputs that need a gradient, as JAX `_c3_bwd`."""
    rng = np.random.RandomState(4)
    C = 5
    args = [_t(rng.randn(*s).astype(np.float32)) for s in
            ((2, 4, 6, 5, C), (5, 5, 5, 1, C), (C,), (7, 7, 7, 1, C), (C,))]
    g = _t(rng.randn(2, 4, 6, 5, C).astype(np.float32))
    need = (True, True, False, True, True)
    # the wrapper's Function takes (kernel, plain, *inputs): two leading
    # non-tensor arguments without gradients
    ctx = SimpleNamespace(saved_tensors=tuple(args), plain=dw_chain3d,
                          needs_input_grad=(False, False) + need)
    got = kernels._PlainVjp.backward(ctx, g)
    assert got[:2] == (None, None)
    got = got[2:]
    leaves = [a.clone().requires_grad_(n) for a, n in zip(args, need)]
    ref = torch.autograd.grad(dw_chain3d(*leaves), [l for l in leaves if l.requires_grad], g)
    assert got[2] is None
    for a, r in zip([a for a in got if a is not None], ref):
        torch.testing.assert_close(a, r)
