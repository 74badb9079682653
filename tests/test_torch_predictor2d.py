"""The port's LKA Baseline, `maxvit_lka_former(num_classes=9)` at full
width and depth, against the JAX package's at img_size 64, batch 2, on the
CPU in float32; its LKA-chain sites; the weight round trip; and
`Predictor2D` against the JAX package's on a 5×96×80 case with a 64²
patch and slice batch 4 (host zoom both ways, a zero-padded last chunk,
the labels), with `evaluate_case`, the latency harness and the 2D path's
`build` on the CPU.

Tolerance of the logits: max|port − JAX| ≤ 1e-4·max(1, max|JAX|), argmax
equal everywhere; the labels and the per-class metrics are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deformablelka_tpu.inference.predictor2d import Predictor2D as JPredictor2D
from deformablelka_tpu.nn import lka2d as jlka2d
from deformablelka_tpu_torch import main_path2d
from deformablelka_tpu_torch.inference.predictor2d import (
    Predictor2D, benchmark_inference_speed)

from test_torch_model2d import (IMG, carried_model, check_against_jax,
                                check_round_trip, count_calls)

torch.set_num_threads(1)
CASE = (5, 96, 80)


@pytest.fixture(scope="module")
def baseline():
    return carried_model(deformable=False)


@pytest.fixture(scope="module")
def predicted(baseline):
    """A case, its labels from both predictors, and both predictors."""
    _, jm, v, _, tm = baseline
    image = np.random.RandomState(3).randn(*CASE).astype(np.float32)
    jp = JPredictor2D(jm.apply, v, patch_size=(IMG, IMG), num_classes=9, slice_batch=4)
    tp = Predictor2D(tm, (IMG, IMG), num_classes=9, slice_batch=4, device="cpu")
    return image, jp.predict_volume(image), tp.predict_volume(image), jp, tp


def test_lka_baseline_matches_jax(baseline):
    check_against_jax(baseline, "lka_baseline")


def test_jax_baseline_has_six_chain_sites(baseline):
    """decoder_2/1/0 apply layer_lka_1 twice, one LKA chain apiece."""
    x, jm, v, _, _ = baseline
    chains, p1 = count_calls(jlka2d, "_dw_pair2d")
    deforms, p2 = count_calls(jlka2d, "deform_conv2d")
    with p1, p2:
        jax.eval_shape(jm.apply, v, jnp.asarray(x))
    assert (len(chains), len(deforms)) == (6, 0)


def test_baseline_state_dict_round_trips_through_the_jax_converter(baseline):
    check_round_trip(baseline, deformable=False)


def test_predict_volume_matches_jax(predicted):
    _, ref, got, _, _ = predicted
    assert got.shape == ref.shape == CASE and got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    assert np.unique(got).size > 1


def test_evaluate_case_matches_jax(predicted):
    image, ref, _, jp, tp = predicted
    label = np.roll(ref, 3, axis=1)
    _, want = jp.evaluate_case(image, label, spacing=(1.0, 1.0, 2.0))
    _, got = tp.evaluate_case(image, label, spacing=(1.0, 1.0, 2.0))
    np.testing.assert_allclose(np.asarray(got, float), np.asarray(want, float), rtol=1e-12)


def test_latency_harness_runs_on_the_cpu(baseline):
    mean, std = benchmark_inference_speed(baseline[4], (IMG, IMG), warmup=1,
                                          reps=2, device="cpu")
    assert mean > 0 and std >= 0


@pytest.mark.parametrize("config", main_path2d.FLAGSHIP)
def test_2d_path_builds_and_predicts_on_the_cpu(config):
    model, predictor = main_path2d.build(config, seed=0, device="cpu", img_size=IMG)
    image = main_path2d.case(seed=0, shape=(3, 80, 72))
    labels = predictor.predict_volume(image)
    assert labels.shape == (3, 80, 72) and labels.dtype == np.int32
    assert 0 <= labels.min() and labels.max() < main_path2d.NUM_CLASSES
    assert predictor.slice_batch == main_path2d.SLICE_BATCH
