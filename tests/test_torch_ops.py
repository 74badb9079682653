"""The PyTorch port's ops against the JAX package, on the CPU, in float32.

Inputs come from seeded numpy and go through both packages. Tolerances:
atol/rtol 1e-5 where both sides do the same f32 arithmetic in another
order (a few hundred terms per output); 5e-5 where an output sums
thousands of terms (the deform conv's 27·C products, the 468-tap chain).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deformablelka_tpu.ops import convs as jconvs
from deformablelka_tpu.ops import deform_conv3d_gather
from deformablelka_tpu.ops import lka as jlka
from deformablelka_tpu.ops.pallas.deform3d_kernel import deform_conv3d_pallas
from deformablelka_tpu.ops.pallas.lka_fused_kernel import dw_chain3d_fused
from deformablelka_tpu_torch.ops import convs, kernels
from deformablelka_tpu_torch.ops.deform3d import deform_conv3d
from deformablelka_tpu_torch.ops.lka import dw_chain3d, lka3d

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _torch_w(w):
    """JAX (kd, kh, kw, Cin/g, Cout) → torch (Cout, Cin/g, kd, kh, kw)."""
    return _t(np.transpose(w, (4, 3, 0, 1, 2)))


@pytest.mark.parametrize("k,s,d", [((3, 3, 3), 1, 1), ((2, 4, 4), (2, 4, 4), 1),
                                   ((7, 7, 7), 2, 3), ((5, 3, 1), 1, (1, 2, 1))])
def test_same_padding_matches_jax(k, s, d):
    assert convs.same_padding(k, s, d, 3) == jconvs.same_padding(k, s, d, 3)


@pytest.mark.parametrize("k,s,d,groups", [(3, 1, 1, 1), (1, 1, 1, 1),
                                          (2, 2, 1, 1), ((2, 4, 4), (2, 4, 4), 1, 1),
                                          (5, 1, 1, 4), (7, 1, 3, 4)])
def test_conv3d_matches_jax(k, s, d, groups):
    rng = np.random.RandomState(0)
    ks = k if isinstance(k, tuple) else (k,) * 3
    x = rng.randn(2, 8, 8, 8, 4).astype(np.float32)
    w = (rng.randn(*ks, 4 // groups, 6 if groups == 1 else 4) * 0.2).astype(np.float32)
    b = rng.randn(w.shape[-1]).astype(np.float32)
    ref = jconvs.conv3d(jnp.asarray(x), jnp.asarray(w), stride=s, dilation=d,
                        groups=groups, bias=jnp.asarray(b))
    got = convs.conv3d(_t(x), _torch_w(w), _t(b), stride=s, dilation=d,
                       groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("k", [2, (2, 4, 4), 3])
def test_conv_transpose_matches_jax(k):
    rng = np.random.RandomState(1)
    ks = k if isinstance(k, tuple) else (k,) * 3
    st = ks if k != 3 else (2, 2, 2)
    x = rng.randn(1, 3, 4, 4, 5).astype(np.float32)
    w = (rng.randn(*ks, 5, 3) * 0.2).astype(np.float32)
    ref = jconvs.conv_transpose(jnp.asarray(x), jnp.asarray(w), stride=st)
    got = convs.conv_transpose(x=_t(x), w=_t(np.transpose(w, (3, 4, 0, 1, 2))),
                               stride=st)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def _deform_inputs(seed, shape, C, amp, cout=None):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape, C).astype(np.float32)
    off = rng.uniform(-amp, amp, shape + (81,)).astype(np.float32)
    w = (rng.randn(3, 3, 3, C, cout or C) / np.sqrt(27 * C)).astype(np.float32)
    b = rng.randn(cout or C).astype(np.float32)
    return x, off, w, b


@pytest.mark.parametrize("shape,C,cout", [((2, 4, 6, 5), 4, None),
                                          ((1, 5, 5, 5), 8, 6),
                                          ((1, 3, 4, 4), 32, None)])
def test_deform_plain_matches_gather_past_the_border(shape, C, cout):
    """Offsets up to ±2.5: many samples have corners outside the volume."""
    x, off, w, b = _deform_inputs(0, shape, C, 2.5, cout)
    assert (np.abs(off) > 1).mean() > 0.5
    ref = deform_conv3d_gather(jnp.asarray(x), jnp.asarray(off), jnp.asarray(w),
                               jnp.asarray(b), stride=1, padding=1, dilation=1)
    got = deform_conv3d(_t(x), _t(off), _t(w), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5, rtol=5e-5)


def test_deform_plain_matches_gather_strided_dilated():
    rng = np.random.RandomState(4)
    x = rng.randn(1, 7, 6, 8, 3).astype(np.float32)
    w = (rng.randn(3, 3, 3, 3, 5) * 0.2).astype(np.float32)
    off = rng.uniform(-1.7, 1.7, (1, 4, 3, 4, 81)).astype(np.float32)
    kw = dict(stride=2, padding=2, dilation=2)
    ref = deform_conv3d_gather(jnp.asarray(x), jnp.asarray(off), jnp.asarray(w),
                               None, **kw)
    got = deform_conv3d(_t(x), _t(off), _t(w), None, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("shape,C", [((1, 4, 6, 8), 4), ((2, 4, 4, 4), 8)])
def test_deform_plain_matches_pallas_interpret(shape, C):
    """The TPU kernel (interpret mode) at |Δ| ≤ 1, where its R=1 clip is
    lossless."""
    x, off, w, _ = _deform_inputs(1, shape, C, 1.0)
    ref = deform_conv3d_pallas(jnp.asarray(x), jnp.asarray(off), jnp.asarray(w),
                               1, True)
    got = deform_conv3d(_t(x), _t(off), _t(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5, rtol=5e-5)


def test_deform_plain_identity_offsets_is_conv():
    """Zero offsets sample the grid itself: a plain 3³ conv, pad 1."""
    x, _, w, b = _deform_inputs(2, (1, 5, 4, 6), 3, 0.0, 4)
    off = np.zeros((1, 5, 4, 6, 81), np.float32)
    got = deform_conv3d(_t(x), _t(off), _t(w), _t(b))
    ref = convs.conv3d(_t(x), _torch_w(w), _t(b), padding=1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)


def _chain_inputs(seed, shape, C):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape, C).astype(np.float32),
            (rng.randn(5, 5, 5, 1, C) * 0.1).astype(np.float32),
            rng.randn(C).astype(np.float32),
            (rng.randn(7, 7, 7, 1, C) * 0.05).astype(np.float32),
            rng.randn(C).astype(np.float32))


@pytest.mark.parametrize("shape,C", [((1, 4, 5, 6), 3), ((2, 8, 8, 8), 4),
                                     ((1, 12, 10, 11), 2)])
def test_chain_plain_matches_jax_chain_and_pallas_interpret(shape, C):
    """The plain chain against the XLA chain and the TPU kernel (interpret
    mode); at 12×10×11 the dilated taps reach interior planes from both
    sides, so the zero outside the volume and the bias only inside it
    both show."""
    args = _chain_inputs(3, shape, C)
    j = [jnp.asarray(a) for a in args]
    ref_xla = np.asarray(jlka.dw_chain3d(*j))
    ref_pallas = np.asarray(dw_chain3d_fused(*j, interpret=True))
    got = dw_chain3d(*map(_t, args)).numpy()
    np.testing.assert_allclose(got, ref_xla, atol=5e-5, rtol=5e-5)
    np.testing.assert_allclose(got, ref_pallas, atol=5e-5, rtol=5e-5)


def test_lka3d_matches_jax():
    x, w5, b5, w7, b7 = _chain_inputs(5, (1, 6, 5, 7), 4)
    rng = np.random.RandomState(6)
    wp = (rng.randn(1, 1, 1, 4, 4) * 0.3).astype(np.float32)
    bp = rng.randn(4).astype(np.float32)
    args = (x, w5, b5, w7, b7, wp, bp)
    ref = jlka.lka3d(*[jnp.asarray(a) for a in args])
    got = lka3d(*map(_t, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5, rtol=5e-5)


def test_wrappers_take_the_plain_version_on_cpu():
    """On a CPU tensor the wrappers compute the plain versions, build
    nothing and count no launch."""
    kernels.reset_launches()
    x, off, w, b = _deform_inputs(7, (1, 4, 4, 4), 4, 2.0)
    np.testing.assert_array_equal(
        kernels.deform_conv3d(_t(x), _t(off), _t(w), _t(b)).numpy(),
        deform_conv3d(_t(x), _t(off), _t(w), _t(b)).numpy())
    args = [_t(a) for a in _chain_inputs(8, (1, 4, 4, 4), 4)]
    np.testing.assert_array_equal(kernels.dw_chain3d(*args).numpy(),
                                  dw_chain3d(*args).numpy())
    assert kernels.deform_conv3d.launches == 0
    assert kernels.dw_chain3d.launches == 0
    assert kernels._lib is None
