"""The port's Pancreas tester against the JAX package's, on the CPU, with
`dlka_net_pancreas` built with a block other than the published one
(`trans_block`, as `cli/test_pancreas.py --trans_block` builds it).

One in-memory case (44×38×20: z padded to the 32³ patch, stride 16, a
2×2×1 grid whose last origins are clamped to the border) goes through
`inference/pancreas.test_all_case` of both packages with the same seeded
weights (JAX variables from `jax.eval_shape` and numpy, carried into the
port by `state_dict_from_jax`). Tolerances: the count-blended
probabilities at atol 1e-4, rtol 1e-4; the labels exactly; the four mean
metrics (Dice, Jaccard, HD95, ASD) within 1e-6. Then the port's CLI runs
the same case from an h5 fold list and a port checkpoint (where h5py
imports) and must give the same metrics exactly. Each Pancreas baseline
name builds the port's model with the JAX registry's structure, and an
unknown name raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from unittest import mock

from deformablelka_tpu.inference import pancreas as jpan
from deformablelka_tpu.models.dlka_former import dlka_net_pancreas as jax_pancreas
from deformablelka_tpu_torch import case_path
from deformablelka_tpu_torch.cli import _pancreas_models
from deformablelka_tpu_torch.cli import test_pancreas as tcli
from deformablelka_tpu_torch.convert.jax_params import state_dict_from_jax
from deformablelka_tpu_torch.inference import pancreas as tpan
from deformablelka_tpu_torch.training.checkpoint import CheckpointManager

from test_torch_block_variants import jax_variables

torch.set_num_threads(1)
PATCH = (32, 32, 32)
BLOCK = "TransformerBlock_SE"
STRIDE = 16


def _recording(fn, store):
    def wrapped(*args):
        out = fn(*args)
        store.append(out)
        return out
    return wrapped


@pytest.fixture(scope="module")
def carried():
    x = np.zeros((1, *PATCH, 1), np.float32)
    jm = jax_pancreas(trans_block=BLOCK, img_size=PATCH)
    v = jax_variables(jm, x, seed=4)
    tm = _pancreas_models.build_pancreas_model("dlka_net", BLOCK, PATCH, device="cpu")
    tm.load_state_dict(state_dict_from_jax(v, tm), strict=True)
    assert sum(type(m).__name__ == BLOCK for m in tm.modules()) == 21
    return jm, v, tm.eval()


def test_tester_with_another_block_matches_jax(carried):
    jm, v, tm = carried
    case = case_path.pancreas_case(seed=2, shape=(44, 38, 20))
    jsw = jpan.make_pancreas_sliding_window(jm.apply, patch_size=PATCH,
                                            stride_xy=STRIDE, stride_z=STRIDE)
    tsw = tpan.make_pancreas_sliding_window(tm, patch_size=PATCH, stride_xy=STRIDE,
                                            stride_z=STRIDE, device="cpu")
    assert tsw.origins((44, 38, 32)) == [(0, 0, 0), (0, 6, 0), (12, 0, 0), (12, 6, 0)]
    jout, tout = [], []
    with mock.patch.object(jpan, "test_single_case", _recording(jpan.test_single_case, jout)):
        ref = jpan.test_all_case(jsw, v, [case], verbose=False)
    with mock.patch.object(tpan, "test_single_case", _recording(tpan.test_single_case, tout)):
        got = tpan.test_all_case(tsw, [case], verbose=False)
    (jlabels, jscore), (tlabels, tscore) = jout[0], tout[0]
    assert tscore.shape == jscore.shape == (2, 44, 38, 20)
    np.testing.assert_allclose(tscore, jscore, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(tlabels, jlabels)
    assert 0.01 < jlabels.mean() < 0.99  # both classes predicted: the metrics are real
    assert np.all(np.isfinite(ref)) and ref[0] > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_cli_runs_an_h5_fold(carried, tmp_path):
    h5py = pytest.importorskip("h5py")
    _, _, tm = carried
    name, image, label = case_path.pancreas_case(seed=2, shape=(44, 38, 20))
    (tmp_path / "Pancreas" / "Flods").mkdir(parents=True)
    with h5py.File(tmp_path / f"{name}.h5", "w") as f:
        f["image"], f["label"] = image, label.astype(np.uint8)
    (tmp_path / "Pancreas" / "Flods" / "test0.list").write_text(f"{name}.h5\n")
    CheckpointManager(tmp_path / "run", async_save=False).save(
        "d_lka_former_iter_6000", {"model": tm.state_dict(), "iteration": 6000})
    avg = tcli.main(["--root_path", str(tmp_path), "--model_dir", str(tmp_path / "run"),
                     "--patch_size", *map(str, PATCH), "--trans_block", BLOCK,
                     "--device", "cpu"])
    tsw = tpan.make_pancreas_sliding_window(tm, patch_size=PATCH, device="cpu")
    np.testing.assert_array_equal(
        avg, tpan.test_all_case(tsw, [(name, image, label)], verbose=False))


@pytest.mark.parametrize("name", _pancreas_models.BASELINES)
def test_baselines_build_and_an_unknown_name_raises(name):
    """Each baseline name builds the port's model at full width with the
    structure of the JAX registry's: every JAX variable (zeros of the
    shapes `jax.eval_shape` gives) has its tensor of the same shape, and
    the port has no other."""
    from deformablelka_tpu.cli import _pancreas_models as jax_models

    model = _pancreas_models.build_pancreas_model(name, BLOCK, PATCH, device="cpu", seed=3)
    jm = jax_models.build_pancreas_model(name, BLOCK, PATCH)
    assert type(model).__name__ == type(jm).__name__
    assert not model.training and all(torch.isfinite(p).all() for p in model.parameters())
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, *PATCH, 1)))
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    model.load_state_dict(state_dict_from_jax(zeros, model), strict=True)
    with pytest.raises(KeyError):
        _pancreas_models.build_pancreas_model("unet", BLOCK, PATCH, device="cpu")
