"""The port's 3D case predictor against the JAX package's, on the CPU:
`restore_softmax_to_original` on seeded softmaxes (with and without
separate z, with a crop, and without resampling), and
`Predictor3D.predict_file` with two folds of the carried
`dlka_former_synapse` at patch (16, 32, 32) on a small CT-like NIfTI case
(resampled to (16, 40, 32), two tiles, flips along the last axis) against
the JAX `Predictor3D.predict_case` on the same case and weights.

Tolerances: the restore exactly (labels equal at every voxel); the
fold-averaged probabilities at atol 1e-4, rtol 1e-4 (21 blocks in
float32, as `test_torch_sliding_window.py`); the written labels exactly
wherever the top two of the JAX package's restored probabilities differ
by more than 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deformablelka_tpu.data import preprocessing as jpre
from deformablelka_tpu.inference import predictor3d as jp3
from deformablelka_tpu.models.dlka_former import dlka_former_synapse as jax_synapse
from deformablelka_tpu_torch import case_path
from deformablelka_tpu_torch.cli.predict_simple import CT_INTENSITY
from deformablelka_tpu_torch.convert.jax_params import state_dict_from_jax
from deformablelka_tpu_torch.data import nifti
from deformablelka_tpu_torch.data import preprocessing as tpre
from deformablelka_tpu_torch.inference import predictor3d as tp3
from deformablelka_tpu_torch.models.dlka_former import dlka_former_synapse

from test_torch_block_variants import jax_variables

torch.set_num_threads(1)
IMG = (16, 32, 32)
PRE = dict(normalization_schemes=["CT"], use_nonzero_mask=[False],
           target_spacing=[3.0, 0.76, 0.76], intensity_properties=CT_INTENSITY)


def _softmax(rng, shape, C):
    z = rng.randn(*shape, C).astype(np.float32) * 3
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("orig,target", [
    ((3.75, 0.9, 0.9), (3.0, 0.76, 0.76)),   # separate z, from the original
    ((1.0, 1.0, 1.0), (3.5, 0.9, 1.0)),      # separate z, from the target
    ((1.0, 0.9, 1.1), (1.2, 0.8, 0.9)),      # no separate z
    ((1.0, 1.0, 1.0), (1.0, 1.0, 1.0)),      # no resampling
])
def test_restore_matches_jax(orig, target):
    rng = np.random.RandomState(0)
    bbox = [[1, 14], [2, 26], [0, 21]]
    crop = [hi - lo for lo, hi in bbox]
    pre_shape = [int(round(o / t * s)) for o, t, s in zip(orig, target, crop)]
    props = {"original_shape": (15, 29, 21), "crop_bbox": bbox,
             "original_spacing": list(orig), "target_spacing": list(target)}
    sm = _softmax(rng, pre_shape, 5)
    got = tp3.restore_softmax_to_original(sm, props)
    ref = jp3.restore_softmax_to_original(sm, props)
    assert got.dtype == ref.dtype == np.uint8 and got.shape == (15, 29, 21)
    np.testing.assert_array_equal(got, ref)
    assert len(np.unique(got)) == 5


def _restored_softmax(probs, props):
    """The JAX package's restore without its argmax: the softmax in the
    original geometry (zeros outside the crop)."""
    crop = [hi - lo for lo, hi in props["crop_bbox"]]
    sep = (jpre.get_do_separate_z(props["target_spacing"])
           or jpre.get_do_separate_z(props["original_spacing"]))
    axis = jpre.get_lowres_axis(props["original_spacing"]) if sep else None
    data = jpre.resample_data_or_seg(np.moveaxis(probs, -1, 0), crop, False, axis, 1, 0, sep)
    out = np.zeros((*props["original_shape"], probs.shape[-1]), np.float32)
    out[tuple(slice(lo, hi) for lo, hi in props["crop_bbox"])] = np.moveaxis(data, 0, -1)
    return out


def test_predictor_two_folds_matches_jax(tmp_path):
    case = case_path.write_case(tmp_path / "in", seed=3, shape=(13, 34, 27))
    img = nifti.load(case)
    x = np.zeros((1, *IMG, 1), np.float32)
    jm = jax_synapse(num_classes=14, do_ds=False, img_size=IMG)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    folds = [jax_variables(jm, x, seed, shapes=shapes) for seed in (0, 1)]
    models = []
    for v in folds:
        tm = dlka_former_synapse(14, do_ds=False, img_size=IMG, device="cpu")
        tm.load_state_dict(state_dict_from_jax(v, tm), strict=True)
        models.append(tm)

    jp = jp3.Predictor3D(jm.apply, folds, jpre.GenericPreprocessor(**PRE), IMG, 14)
    jp.sw.mirror_axes = (2,)
    jseg, jprobs, jprops = jp.predict_case(np.asarray(img.data, np.float32)[None],
                                           img.spacing)
    tp = tp3.Predictor3D(models, tpre.GenericPreprocessor(**PRE), IMG, 14, device="cpu")
    for sw in tp.engines:
        sw.mirror_axes = (2,)
    seen = {}
    predict_case = tp.predict_case
    tp.predict_case = lambda *a: seen.setdefault("out", predict_case(*a))
    out = tmp_path / "out.nii.gz"
    written = tp.predict_file(case, out)
    _, probs, props = seen["out"]

    assert props == jprops and probs.shape == jprobs.shape == (16, 40, 32, 14)
    assert tp.last_case["tiles"] == 2 and tp.last_case["preprocessed_shape"] == (16, 40, 32)
    np.testing.assert_allclose(probs, jprobs, atol=1e-4, rtol=1e-4)
    back = nifti.load(out)
    assert back.data.dtype == np.uint8 and back.data.shape == img.data.shape
    np.testing.assert_array_equal(back.affine, img.affine)
    np.testing.assert_array_equal(back.data, written)
    top2 = np.sort(_restored_softmax(jprobs, jprops), axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(back.data[clear], jseg[clear])
    assert len(np.unique(jseg)) > 3
