"""The port's sliding window in the Pancreas tester's mode against the JAX
package's, on the CPU: the stride grid (`compute_steps_stride`) exactly;
the count-blended probabilities of a toy network on the stride grid, with
padding; and the per-call `predict(do_mirroring=False)` override of an
engine built with mirroring.

Tolerance on probabilities: atol 1e-5, rtol 1e-5 (one conv, then softmax
and blending in float32, as `test_torch_sliding_window.py`); the labels
exactly where the top two probabilities differ by more than 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from deformablelka_tpu.inference import sliding_window as jsw
from deformablelka_tpu_torch.inference import sliding_window as tsw
from deformablelka_tpu_torch.ops.convs import conv3d

from test_torch_sliding_window import _toy_weights

torch.set_num_threads(1)

# (patch, image, stride_xy, stride_z): spans that are stride multiples, spans
# whose last origin is clamped to the border, spans of 0 (one origin) and the
# Pancreas protocol's 96³ patch over a 128×128×96 padded volume
STEP_CASES = [
    ((96, 96, 96), (128, 128, 96), 16, 16),
    ((96, 96, 96), (150, 101, 97), 16, 16),
    ((16, 16, 16), (40, 37, 16), 16, 4),
    ((8, 8, 8), (9, 30, 31), 5, 7),
    ((5, 6, 7), (5, 6, 7), 16, 16),
    ((4, 4, 4), (20, 21, 22), 3, 1),
]


@pytest.mark.parametrize("patch,image,sxy,sz", STEP_CASES)
def test_stride_steps_match_jax(patch, image, sxy, sz):
    got = tsw.compute_steps_stride(patch, image, sxy, sz)
    assert got == jsw.compute_steps_stride(patch, image, sxy, sz)
    for steps, p, s in zip(got, patch, image):
        assert steps[0] == 0 and steps[-1] == s - p  # the border is reached


def _engines(patch, ncls=4, **kw):
    w, b = _toy_weights(ncls)

    def japply(params, x):
        return lax.conv_general_dilated(
            x, params[0], (1, 1, 1), [(1, 1)] * 3,
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC")) + params[1]

    wt, bt = torch.from_numpy(w).permute(4, 3, 0, 1, 2), torch.from_numpy(b)
    jsi = jsw.SlidingWindowInference(japply, patch, ncls, loop_mode="host", **kw)
    tsi = tsw.SlidingWindowInference(lambda x: conv3d(x, wt, bt, padding=1), patch,
                                     ncls, device="cpu", **kw)
    return jsi, tsi, (jnp.asarray(w), jnp.asarray(b))


def _assert_probs(got, ref):
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got.argmax(-1)[clear], ref.argmax(-1)[clear])


@pytest.mark.parametrize("shape,sxy,sz", [((27, 21, 12), 4, 6), ((26, 20, 9), 3, 16)])
def test_stride_mode_count_blending_matches_jax(shape, sxy, sz):
    """Overlapping tiles on a clamped grid, z padded up to the patch."""
    vol = np.random.RandomState(2).randn(*shape, 1).astype(np.float32)
    jsi, tsi, params = _engines((16, 16, 16), do_mirroring=False, use_gaussian=False,
                                grid_mode="stride", stride_xy=sxy, stride_z=sz)
    assert len(tsi.origins(tuple(max(s, 16) for s in shape))) >= 3
    _assert_probs(tsi.predict(vol), jsi.predict(params, vol))


def test_predict_mirroring_override_matches_jax():
    """An engine built with mirroring, asked for none in one call. The
    port's override is for that call: its next call mirrors again, as a
    fresh JAX engine with mirroring does. (The JAX engine keeps the
    override for later calls, and in its host loop keeps the mirroring of
    its first call: it is not the reference for the second call.)"""
    vol = np.random.RandomState(3).randn(20, 13, 18, 1).astype(np.float32)
    jsi, tsi, params = _engines((16, 16, 16), do_mirroring=True, tta_batch=2)
    ref = jsi.predict(params, vol, do_mirroring=False)
    _assert_probs(tsi.predict(vol, do_mirroring=False), ref)
    mirrored = tsi.predict(vol)
    assert np.abs(mirrored - ref).max() > 1e-3
    fresh, _, _ = _engines((16, 16, 16), do_mirroring=True, tta_batch=2)
    _assert_probs(mirrored, fresh.predict(params, vol))


def test_grid_mode_is_checked():
    with pytest.raises(ValueError):
        tsw.SlidingWindowInference(lambda x: x, (4, 4, 4), 2, grid_mode="strided",
                                   device="cpu")
