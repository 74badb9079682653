"""The dilated 3D depthwise conv of the port (`ops/dwconv3d.py`, the plain
version of `ops.kernels.dwconv3d`) against the JAX package, on the CPU in
float32: its values against the Pallas kernel `depthwise_conv3d_pallas`
in interpret mode and against JAX's `depthwise_conv3d`, its gradients
against `jax.grad`, the wrapper's CPU path and its autograd, and
`dwconv3d_site` against the JAX package's own dispatch decision.

Tolerance: max|port − JAX| ≤ 1e-4·max(1, max|JAX|) (sums of up to 343
f32 terms in another order on each side).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deformablelka_tpu.ops import convs as jconvs
from deformablelka_tpu.ops.pallas import dwconv3d_kernel as jdw
from deformablelka_tpu_torch.ops import kernels
from deformablelka_tpu_torch.ops.dwconv3d import depthwise_conv3d_dilated, dwconv3d_site

torch.set_num_threads(1)

# the four cases of test_deform_ops.py::test_dwconv3d_pallas_interpret_parity,
# then the two sites of the size-aware gate: ((D, H, W), C, K, dil)
CASES = [((8, 16, 16), 32, 5, 1), ((8, 16, 16), 32, 7, 3),
         ((4, 8, 8), 256, 3, 1), ((10, 14, 22), 8, 7, 3),
         ((8, 8, 8), 128, 5, 3), ((4, 4, 4), 256, 3, 2)]
IDS = [f"{'x'.join(map(str, s))}C{c}K{k}d{d}" for s, c, k, d in CASES]


def _inputs(shape, C, K, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, *shape, C).astype(np.float32)
    w = (rng.randn(K, K, K, 1, C) / K ** 1.5).astype(np.float32)
    b = (rng.randn(C) * 0.1).astype(np.float32)
    return x, w, b


def _close(got, ref):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max()
    assert err <= 1e-4 * max(1.0, np.abs(ref).max()), err


@pytest.mark.parametrize("shape,C,K,dil", CASES, ids=IDS)
def test_plain_version_matches_the_pallas_kernel_and_jax(shape, C, K, dil):
    x, w, b = _inputs(shape, C, K)
    got = depthwise_conv3d_dilated(torch.from_numpy(x), torch.from_numpy(w),
                                   None, dil).numpy()
    _close(got, jdw.depthwise_conv3d_pallas(jnp.asarray(x), jnp.asarray(w),
                                            K, dil, True))
    got_b = depthwise_conv3d_dilated(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(b), dil).numpy()
    _close(got_b, jconvs.depthwise_conv3d(
        jnp.asarray(x), jnp.asarray(w), padding=dil * (K // 2), dilation=dil,
        bias=jnp.asarray(b)))


@pytest.mark.parametrize("shape,C,K,dil", [CASES[1], CASES[4], CASES[5]],
                         ids=[IDS[1], IDS[4], IDS[5]])
def test_plain_version_gradients_match_jax(shape, C, K, dil):
    x, w, b = _inputs(shape, C, K)
    g = np.random.RandomState(1).randn(*x.shape).astype(np.float32)

    def loss(x, w, b):
        y = jconvs.depthwise_conv3d(x, w, padding=dil * (K // 2), dilation=dil,
                                    bias=b)
        return jnp.sum(y * jnp.asarray(g))

    ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    (depthwise_conv3d_dilated(xt, wt, bt, dil) * torch.from_numpy(g)).sum().backward()
    for got, r in zip((xt.grad, wt.grad, bt.grad), ref):
        _close(got.numpy(), r)


def test_wrapper_on_a_cpu_tensor_is_the_plain_version():
    x, w, b = map(torch.from_numpy, _inputs((8, 8, 8), 128, 5))
    before = kernels.dwconv3d.launches
    assert torch.equal(kernels.dwconv3d(x, w, b, 3),
                       depthwise_conv3d_dilated(x, w, b, 3))
    assert torch.equal(kernels.dwconv3d(x, w, None, 3),
                       depthwise_conv3d_dilated(x, w, None, 3))
    assert kernels.dwconv3d.launches == before
    assert kernels.dwconv3d in kernels.WRAPPERS


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
def test_plain_vjp_backward_is_the_plain_gradient(with_bias):
    """`_PlainVjp` as `kernels.dwconv3d` applies it on the card, with the
    plain version standing in for the kernel's forward."""
    x, w, b = map(torch.from_numpy, _inputs((4, 4, 4), 256, 3))
    gy = torch.randn(x.shape, generator=torch.Generator().manual_seed(2))

    def grads(fn):
        ins = [t.clone().requires_grad_() for t in ((x, w, b) if with_bias else (x, w))]
        fn(*ins).backward(gy)
        return [t.grad for t in ins]

    plain = (lambda *t: depthwise_conv3d_dilated(*t, 2)) if with_bias else \
        (lambda x, w: depthwise_conv3d_dilated(x, w, None, 2))
    got = grads(lambda *t: kernels._PlainVjp.apply(plain, plain, *t))
    for a, r in zip(got, grads(plain)):
        torch.testing.assert_close(a, r, rtol=0, atol=0)


GRID = [(k, dil, stride, pad, depthwise, aniso)
        for k in (3, 4, 5, 7) for dil in (1, 2, 3) for stride in (1, 2)
        for pad in ("same", "dk", "dk+1", 0) for depthwise in (True, False)
        for aniso in ("cubic", "kernel", "dilation")]


def _jax_takes_the_kernel(monkeypatch, x_shape, w_shape, stride, padding, dilation,
                          groups):
    """Whether the JAX package's `conv3d` sends this conv to
    `depthwise_conv3d_pallas` when that route is on and supported."""
    taken = []
    monkeypatch.setenv("DLKA_DWCONV_IMPL", "pallas")
    monkeypatch.setattr(jdw, "dwconv3d_supported", lambda *a: True)
    monkeypatch.setattr(jdw, "depthwise_conv3d_pallas",
                        lambda x, w, k, d: taken.append(1) or x)
    jax.eval_shape(lambda x, w: jconvs.conv3d(
        x, w, stride=stride, padding=padding, dilation=dilation, groups=groups),
        jax.ShapeDtypeStruct(x_shape, jnp.float32),
        jax.ShapeDtypeStruct(w_shape, jnp.float32))
    return bool(taken)


def test_site_predicate_is_the_jax_dispatch_condition(monkeypatch):
    C = 8
    hits = 0
    for k, dil, stride, pad, depthwise, aniso in GRID:
        ks = (k, k, k - 2) if aniso == "kernel" else (k, k, k)
        dl = (1, dil, dil) if aniso == "dilation" else dil
        padding = {"dk": dil * (k // 2), "dk+1": dil * (k // 2) + 1}.get(pad, pad)
        groups = C if depthwise else 1
        w_shape = (*ks, C // groups, C)
        want = _jax_takes_the_kernel(monkeypatch, (1, 24, 24, 24, C), w_shape,
                                     stride, padding, dl, groups)
        got = dwconv3d_site(w_shape, stride, padding, dl, groups, C)
        assert got == want, (k, dil, stride, pad, depthwise, aniso)
        hits += want
    assert hits == 2 * 3 * 2  # odd k in (3, 5, 7), dil > 1, "same" or dk
