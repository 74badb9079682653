"""The port's general 2D deformable conv (`ops.deform2d.deform_conv2d`: any
groups, stride, padding and dilation) against the JAX package's gather form
(`deformablelka_tpu/ops/deform2d.py` `deform_conv2d`) and `jax.grad` of it,
on the CPU.

C = 8 input channels, groups ∈ {1, 2, C/2 = 4} (and C, the depthwise case,
once), stride 1 and 2, padding 0-2, dilation 1-2, a non-square kernel, a
bias; offsets uniform in ±2.5, a quarter of them exact integers (where the
gather's offset gradient is the right derivative in both packages: ROADMAP
Queue 3 item 2). Forward atol 1e-5, the gradients of x, offset, w and bias
atol 1e-4.
"""

import numpy as np
import pytest
import torch

from deformablelka_tpu_torch.ops import deform2d

torch.set_num_threads(1)
C = 8
# (groups, Cout, (kh, kw), stride, padding, dilation)
CASES = [(1, 6, (3, 3), 1, 1, 1), (2, 6, (3, 3), 2, 1, 1), (4, 8, (3, 3), 1, 2, 2),
         (1, 4, (3, 2), 2, (0, 1), (1, 2)), (2, 4, (5, 5), 1, 2, 1), (4, 12, (3, 3), 2, 0, 2),
         (C, C, (3, 3), 2, 1, 1)]


def _case(groups, cout, k, stride, padding, dilation, seed=0):
    rng = np.random.RandomState(seed)
    kh, kw = k
    B, H, W = 2, 11, 9
    s = (stride, stride) if isinstance(stride, int) else stride
    p = (padding, padding) if isinstance(padding, int) else padding
    d = (dilation, dilation) if isinstance(dilation, int) else dilation
    Ho = (H + 2 * p[0] - d[0] * (kh - 1) - 1) // s[0] + 1
    Wo = (W + 2 * p[1] - d[1] * (kw - 1) - 1) // s[1] + 1
    x = rng.randn(B, H, W, C).astype(np.float32)
    off = rng.uniform(-2.5, 2.5, (B, Ho, Wo, 2 * kh * kw)).astype(np.float32)
    integer = rng.rand(*off.shape) < 0.25
    off[integer] = np.round(off[integer])
    w = (rng.randn(kh, kw, C // groups, cout) / np.sqrt(kh * kw * C // groups)).astype(
        np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    g = rng.randn(B, Ho, Wo, cout).astype(np.float32)
    return x, off, w, b, g


@pytest.mark.parametrize("case", CASES, ids=[f"g{c[0]}-s{c[3]}-p{c[4]}-d{c[5]}-k{c[2]}"
                                             for c in CASES])
def test_general_deform_conv2d_matches_jax(case):
    import jax
    import jax.numpy as jnp

    from deformablelka_tpu.ops.deform2d import deform_conv2d as jax_deform_conv2d

    groups, cout, k, stride, padding, dilation = case
    x, off, w, b, g = _case(*case)
    kw = dict(stride=stride, padding=padding, dilation=dilation, groups=groups)
    ref = jax_deform_conv2d(*map(jnp.asarray, (x, off, w, b)), **kw)
    ref_grads = jax.grad(lambda *a: jnp.sum(jax_deform_conv2d(*a, **kw) * g),
                         argnums=(0, 1, 2, 3))(*map(jnp.asarray, (x, off, w, b)))
    inputs = [torch.from_numpy(a).requires_grad_() for a in (x, off, w, b)]
    got = deform2d.deform_conv2d(*inputs, **kw)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    got.backward(torch.from_numpy(g))
    for name, t, r in zip(("x", "offset", "w", "bias"), inputs, ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=1e-4, rtol=0,
                                   err_msg=name)


def test_depthwise_case_is_the_kernels_plain_version():
    """deform_dw_conv2d (kernel 4's plain version) is deform_conv2d's
    depthwise stride-1 'same' case, bitwise."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(1, 7, 6, C).astype(np.float32))
    off = torch.from_numpy(rng.uniform(-2, 2, (1, 7, 6, 18)).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 3, 1, C).astype(np.float32))
    torch.testing.assert_close(deform2d.deform_dw_conv2d(x, off, w, 2),
                               deform2d.deform_conv2d(x, off, w, padding=2, dilation=2,
                                                      groups=C), rtol=0, atol=0)
