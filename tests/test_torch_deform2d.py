"""The port's plain 2D depthwise deform conv and 2D LKA chain, and the CPU
plumbing of their kernel wrappers, against the JAX package, on the CPU in
float32.

- The deform conv against JAX's gather form (`deform_conv2d_gather`) at
  the decoder's two sites, 5×5 and 7×7 dilation 3, with offsets in ±2.5
  that include exact integers and 0: tolerance 1e-5·max(1, max|JAX|).
- Its gradients (x, offsets, weights) against `jax.grad` of the gather,
  at non-integer offsets and at integer ones, where both take the right
  derivative x(y0 + 1) − x(y0): tolerance 1e-5·max(1, max|JAX|).
- The TPU kernel itself, `deform_dw_conv2d_pallas` in interpret mode, at
  |Δ| ≤ R, where its clipped window is exact.
- The chain against JAX's `dw_chain2d` and the fused TPU kernel
  `dw_chain2d_fused` in interpret mode; its gradients against `jax.grad`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deformablelka_tpu.ops import deform_conv2d_gather
from deformablelka_tpu.ops import lka as jlka
from deformablelka_tpu.ops.pallas.deform2d_kernel import deform_dw_conv2d_pallas
from deformablelka_tpu.ops.pallas.lka_fused_kernel import dw_chain2d_fused
from deformablelka_tpu_torch.ops import deform2d, kernels, lka

torch.set_num_threads(1)
SITES = [(5, 1), (7, 3)]  # (k, dilation) of the decoder's two deform convs


def _case(k, seed=0, B=2, H=12, W=10, C=8, span=2.5, integer=True):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, C).astype(np.float32)
    off = rng.uniform(-span, span, (B, H, W, 2 * k * k)).astype(np.float32)
    if integer:  # a quarter of the offsets exact integers, a tenth zero
        pick = rng.rand(*off.shape)
        off = np.where(pick < 0.25, np.round(off), off)
        off = np.where(pick < 0.1, 0.0, off).astype(np.float32)
    else:  # every offset at least 0.1 from an integer
        off = (np.floor(off) + 0.1 + 0.8 * (off - np.floor(off))).astype(np.float32)
    w = rng.randn(k, k, 1, C).astype(np.float32) / k
    return x, off, w


def _jax_deform(x, off, w, dil):
    k, C = w.shape[0], x.shape[-1]
    return deform_conv2d_gather(x, off, w, None, padding=(k // 2) * dil,
                                dilation=dil, groups=C)


def _close(got, ref, rel=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rel * max(1.0, np.abs(ref).max()), err


@pytest.mark.parametrize("k,dil", SITES)
def test_plain_deform_matches_jax_gather(k, dil):
    x, off, w = _case(k)
    assert (off == 0).any() and (off == np.round(off)).mean() > 0.2
    ref = _jax_deform(jnp.asarray(x), jnp.asarray(off), jnp.asarray(w), dil)
    got = deform2d.deform_dw_conv2d(*map(torch.from_numpy, (x, off, w)), dil)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("integer", [False, True], ids=["fractional", "integer"])
@pytest.mark.parametrize("k,dil", SITES)
def test_plain_deform_gradients_match_jax_gather(k, dil, integer):
    x, off, w = _case(k, seed=1, integer=integer)
    g = np.random.RandomState(2).randn(*x.shape).astype(np.float32)
    ref = jax.grad(lambda *a: jnp.sum(_jax_deform(*a, dil) * g), argnums=(0, 1, 2))(
        *map(jnp.asarray, (x, off, w)))
    inputs = [torch.from_numpy(a).requires_grad_() for a in (x, off, w)]
    y = deform2d.deform_dw_conv2d(*inputs, dil)
    got = torch.autograd.grad(y, inputs, torch.from_numpy(g))
    for gt, r in zip(got, ref):
        _close(gt.numpy(), r)


@pytest.mark.parametrize("k,dil", SITES)
def test_plain_deform_matches_the_tpu_kernel_within_its_window(k, dil):
    R = 1
    x, off, w = _case(k, seed=3, B=1, H=8, W=8, C=16, span=R)
    ref = deform_dw_conv2d_pallas(*map(jnp.asarray, (x, off, w)), R, dil, True)
    got = deform2d.deform_dw_conv2d(*map(torch.from_numpy, (x, off, w)), dil)
    _close(got.numpy(), ref)


def test_plain_deform_raises_on_what_is_not_ported():
    x = torch.zeros(1, 6, 6, 4)
    off = torch.zeros(1, 6, 6, 18)
    with pytest.raises(NotImplementedError):
        deform2d.deform_conv2d(x, off, torch.zeros(3, 3, 4, 4), padding=1, groups=1)
    with pytest.raises(NotImplementedError):
        deform2d.deform_conv2d(x, torch.zeros(1, 3, 3, 18), torch.zeros(3, 3, 1, 4),
                               stride=2, padding=1, groups=4)


def _chain_case(seed=4, B=2, H=11, W=13, C=6):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, W, C).astype(np.float32),
            (rng.randn(5, 5, 1, C) / 5).astype(np.float32),
            (rng.randn(C) * 0.1).astype(np.float32),
            (rng.randn(7, 7, 1, C) / 7).astype(np.float32),
            (rng.randn(C) * 0.1).astype(np.float32))


@pytest.mark.parametrize("ref_fn", [jlka.dw_chain2d,
                                    lambda *a: dw_chain2d_fused(*a, True)],
                         ids=["chain", "fused-interpret"])
def test_plain_chain_matches_jax(ref_fn):
    args = _chain_case()
    ref = ref_fn(*map(jnp.asarray, args))
    _close(lka.dw_chain2d(*map(torch.from_numpy, args)).numpy(), ref)


def test_plain_chain_gradients_match_jax():
    args = _chain_case(seed=5)
    g = np.random.RandomState(6).randn(*args[0].shape).astype(np.float32)
    ref = jax.grad(lambda *a: jnp.sum(jlka.dw_chain2d(*a) * g),
                   argnums=tuple(range(5)))(*map(jnp.asarray, args))
    inputs = [torch.from_numpy(a).requires_grad_() for a in args]
    got = torch.autograd.grad(lka.dw_chain2d(*inputs), inputs, torch.from_numpy(g))
    for gt, r in zip(got, ref):
        _close(gt.numpy(), r)


def test_lka2d_gate_matches_jax():
    args = _chain_case(seed=7)
    rng = np.random.RandomState(8)
    C = args[0].shape[-1]
    w_pw = (rng.randn(1, 1, C, C) / np.sqrt(C)).astype(np.float32)
    b_pw = (rng.randn(C) * 0.1).astype(np.float32)
    ref = jlka.lka2d(*map(jnp.asarray, args + (w_pw, b_pw)))
    got = lka.lka2d(*map(torch.from_numpy, args + (w_pw, b_pw)))
    _close(got.numpy(), ref)


def test_wrappers_take_the_plain_versions_on_cpu_and_count_no_launch():
    x, off, w = map(torch.from_numpy, _case(5, seed=9))
    chain = tuple(map(torch.from_numpy, _chain_case(seed=10)))
    before = (kernels.deform_dw_conv2d.launches, kernels.dw_chain2d.launches)
    torch.testing.assert_close(kernels.deform_dw_conv2d(x, off, w, 1),
                               deform2d.deform_dw_conv2d(x, off, w, 1), rtol=0, atol=0)
    torch.testing.assert_close(kernels.dw_chain2d(*chain), lka.dw_chain2d(*chain),
                               rtol=0, atol=0)
    assert (kernels.deform_dw_conv2d.launches, kernels.dw_chain2d.launches) == before
    assert {kernels.deform_dw_conv2d, kernels.dw_chain2d} <= set(kernels.WRAPPERS)


@pytest.mark.parametrize("which", ["deform", "chain"])
def test_plain_vjp_function_gives_the_plain_gradients(which):
    """The autograd Function the wrappers use on the card, run on the CPU
    with the plain version standing in for the kernel."""
    if which == "deform":
        plain = lambda *t: deform2d.deform_dw_conv2d(*t, 3)
        arrays = _case(7, seed=11, integer=False)
    else:
        plain = lka.dw_chain2d
        arrays = _chain_case(seed=12)
    a = [torch.from_numpy(t).requires_grad_() for t in arrays]
    b = [torch.from_numpy(t).requires_grad_() for t in arrays]
    ya = kernels._PlainVjp.apply(plain, plain, *a)
    yb = plain(*b)
    g = torch.randn(ya.shape, generator=torch.Generator().manual_seed(0))
    for ga, gb in zip(torch.autograd.grad(ya, a, g), torch.autograd.grad(yb, b, g)):
        torch.testing.assert_close(ga, gb, rtol=1e-6, atol=1e-6)
