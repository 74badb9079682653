"""The port's sliding-window inference against the JAX package's, on the
CPU: the step grid, Gaussian map and padding helpers exactly; the
blended, mirror-averaged probabilities of a toy network and of the
carried D-LKA Former at a small patch to float32 tolerance; the labels
exactly where the top two probabilities are not within that tolerance.

Tolerance on probabilities: atol 1e-5 for the toy net (one conv, then
softmax and blending), 1e-4 for the model (21 blocks, see
test_torch_model).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from deformablelka_tpu.inference import sliding_window as jsw
from deformablelka_tpu.models.dlka_former import dlka_former_synapse as jax_synapse
from deformablelka_tpu_torch.convert.jax_params import state_dict_from_jax
from deformablelka_tpu_torch.inference import sliding_window as tsw
from deformablelka_tpu_torch.models.dlka_former import dlka_former_synapse
from deformablelka_tpu_torch.ops.convs import conv3d

from test_torch_modules import perturb

torch.set_num_threads(1)


@pytest.mark.parametrize("patch,image,step", [
    ((64, 128, 128), (96, 192, 160), 0.5), ((16, 16, 16), (20, 37, 16), 0.5),
    ((8, 8, 8), (30, 9, 8), 0.25), ((5, 6, 7), (5, 6, 7), 0.5)])
def test_steps_match_jax(patch, image, step):
    assert tsw.compute_steps(patch, image, step) == jsw.compute_steps(
        patch, image, step)


def test_bench_protocol_has_eight_tiles():
    sw = tsw.SlidingWindowInference(lambda x: x, (64, 128, 128), 14,
                                    device="cpu")
    assert len(sw.origins((96, 192, 160))) == 8


@pytest.mark.parametrize("patch", [(64, 128, 128), (16, 16, 16), (5, 6, 7)])
def test_gaussian_matches_jax(patch):
    np.testing.assert_array_equal(tsw.gaussian_importance_map(patch),
                                  jsw.gaussian_importance_map(patch))


def test_pad_to_min_matches_jax():
    x = np.random.RandomState(0).randn(5, 20, 7, 2).astype(np.float32)
    got, gs = tsw.pad_to_min(x, (8, 16, 16))
    ref, rs = jsw.pad_to_min(x, (8, 16, 16))
    np.testing.assert_array_equal(got, ref)
    assert gs == rs


def _toy_weights(ncls=4, cin=1):
    rng = np.random.RandomState(1)
    w = (rng.randn(3, 3, 3, cin, ncls) * 0.5).astype(np.float32)
    b = rng.randn(ncls).astype(np.float32)
    return w, b


@pytest.mark.parametrize("mirror,tta_batch", [(False, 1), (True, 1), (True, 8),
                                              (True, 3)])
def test_toy_network_matches_jax(mirror, tta_batch):
    """An asymmetric 3³ conv, so a flip that is not undone shows."""
    w, b = _toy_weights()
    vol = np.random.RandomState(2).randn(20, 13, 26, 1).astype(np.float32)
    patch = (16, 16, 16)

    def japply(params, x):
        return lax.conv_general_dilated(
            x, params[0], (1, 1, 1), [(1, 1)] * 3,
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC")) + params[1]

    wt, bt = torch.from_numpy(w).permute(4, 3, 0, 1, 2), torch.from_numpy(b)
    jsi = jsw.SlidingWindowInference(japply, patch, 4, do_mirroring=mirror,
                                     tta_batch=tta_batch, loop_mode="host")
    tsi = tsw.SlidingWindowInference(lambda x: conv3d(x, wt, bt, padding=1),
                                     patch, 4, do_mirroring=mirror,
                                     tta_batch=tta_batch, device="cpu")
    params = (jnp.asarray(w), jnp.asarray(b))
    ref = jsi.predict(params, vol)
    got = tsi.predict(vol)
    assert got.shape == ref.shape == (20, 13, 26, 4)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    seg = tsi.predict_segmentation(vol)
    assert seg.dtype == np.uint8
    np.testing.assert_array_equal(seg, jsi.predict_segmentation(params, vol))


def test_model_matches_jax_at_a_small_patch():
    """The carried D-LKA Former behind both engines: patch (16, 32, 32),
    two tiles along H, flips along W in one batch of two."""
    img = (16, 32, 32)
    vol = np.random.RandomState(3).randn(16, 40, 32, 1).astype(np.float32)
    jm = jax_synapse(num_classes=14, do_ds=False, img_size=img)
    v = jax.tree_util.tree_map(np.asarray, dict(jax.jit(jm.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, *img, 1)))))
    v = perturb(v, seed=6, offset_scale=20.0)
    tm = dlka_former_synapse(num_classes=14, do_ds=False, img_size=img,
                             device="cpu")
    tm.load_state_dict(state_dict_from_jax(v, tm), strict=True)
    kw = dict(patch_size=img, num_classes=14, do_mirroring=True,
              mirror_axes=(2,), tta_batch=2)
    jsi = jsw.SlidingWindowInference(jm.apply, loop_mode="host", **kw)
    tsi = tsw.SlidingWindowInference(tm, device="cpu", **kw)
    assert len(tsi.origins(vol.shape[:3])) == 2
    ref = jsi.predict(v, vol)
    got = tsi.predict(vol)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-3
    assert clear.mean() > 0.9
    seg = tsi.predict_segmentation(vol)
    np.testing.assert_array_equal(seg[clear], np.argmax(ref, -1)[clear])


def test_no_card_raises_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        tsw.SlidingWindowInference(lambda x: x, (8, 8, 8), 2)
    with pytest.raises(RuntimeError):
        dlka_former_synapse(2, do_ds=False, img_size=(16, 32, 32))
