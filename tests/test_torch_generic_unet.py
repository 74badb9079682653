"""nnUNet's GenericUNet in the port against the JAX package's, on the CPU
in float32.

- 2D (5 pools, 32² slices, batch 2) and 3D (3 pools, anisotropic first
  pool, 16×32×32, batch 1) at base width 4 capped at 16, plain, with the
  residual planner variant and with `conv_per_stage=3`: the three deep-
  supervision outputs [full, 1/2, 1/4] within 1e-4·max(1, max|JAX|), on
  the same seeded variables (JAX's from `jax.eval_shape` and seeded
  numpy, carried by `state_dict_from_jax`).
- `generic_unet_3d_from_plans` against JAX's from the same plans (pools,
  conv kernels, the planner variants' knobs), forward as above.
- The weight carry both ways: `convert_generic_unet` run on the port's
  `state_dict()` gives back exactly the variables (also at the CLI's full
  2D width); the transposed convs' kernels are flipped on the way (flax's
  `ConvTranspose`); a value of the wrong shape raises.
- `run_training 2d` for one epoch of one batch at 64² (the CLI's
  GenericUNet, base 32, cap 320): its training and validation losses
  against the JAX `Trainer3D`'s step on the same batches from the same
  weights, rtol 1e-4; `2d` with `-val` is refused by both CLIs (the JAX
  one fails in its 3D sliding window, the port's raises
  `NotImplementedError` first).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deformablelka_tpu.cli import run_training as jax_cli
from deformablelka_tpu.convert import torch_loader as jconv
from deformablelka_tpu.data import augment as jaugment
from deformablelka_tpu.models import generic_unet as jgu
from deformablelka_tpu.training import trainer3d as jtrainer
from deformablelka_tpu.training.train_step import init_train_state
from deformablelka_tpu_torch import trainer_path
from deformablelka_tpu_torch.cli import run_training
from deformablelka_tpu_torch.convert.jax_params import state_dict_from_jax
from deformablelka_tpu_torch.models import generic_unet as tgu
from deformablelka_tpu_torch.training.trainer3d import Trainer3D

from test_torch_maxvit import assert_close, carry, jax_variables
from test_torch_zoo_mit import assert_round_trip

torch.set_num_threads(1)
MODEL_TOL = 1e-4
NARROW = dict(num_classes=3, base_num_features=4, max_features=16)
POOLS_3D = [[1, 2, 2], [2, 2, 2], [2, 2, 2]]
VARIANTS = {"plain": {}, "residual": {"residual": True}, "conv3": {"conv_per_stage": 3}}


def _case(ndim, variant):
    kw = dict(NARROW, ndim=ndim, **VARIANTS[variant])
    if ndim == 2:
        kw["num_pool"] = 5
        x = np.random.RandomState(2).randn(2, 32, 32, 1)
    else:
        kw.update(num_pool=3, pool_kernel_sizes=POOLS_3D)
        x = np.random.RandomState(2).randn(1, 16, 32, 32, 1)
    return jgu.GenericUNet(**kw), tgu.GenericUNet(**kw), x.astype(np.float32)


def _outputs_match(jm, tm, x, seed=0):
    v = jax_variables(jm, x, seed=seed)
    ref = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = carry(v, tm)(torch.from_numpy(x))
    assert len(got) == len(ref) == 3
    assert got[0].shape[:-1] == x.shape[:-1]
    for g, r in zip(got, ref):
        assert_close(g.numpy(), np.asarray(r), MODEL_TOL)
    return v


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("ndim", [2, 3])
def test_forward_matches_jax(ndim, variant):
    jm, tm, x = _case(ndim, variant)
    _outputs_match(jm, tm, x)


@pytest.mark.parametrize("residual", [False, True])
def test_from_plans_matches_jax(residual):
    stage = {"pool_op_kernel_sizes": POOLS_3D,
             "conv_kernel_sizes": [[1, 3, 3], [3, 3, 3], [3, 3, 3], [3, 3, 3]]}
    plans = {"conv_per_stage": 3, "residual": residual}
    jm = jgu.generic_unet_3d_from_plans(stage, 2, plans=plans)
    tm = tgu.generic_unet_3d_from_plans(stage, 2, plans=plans, device="cpu", seed=1)
    assert (jm.num_pool, jm.conv_per_stage, jm.residual) == (3, 3, residual)
    assert tm.num_pool == 3 and not tm.training
    stem = tm.conv_blocks_context[0].blocks[0].conv
    assert tuple(stem.weight.shape[2:]) == (1, 3, 3) and stem.padding == (0, 1, 1)
    x = np.random.RandomState(4).randn(1, 16, 32, 32, 1).astype(np.float32)
    v = jax_variables(jm, x, seed=1)
    ref = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = carry(v, tm)(torch.from_numpy(x))
    for g, r in zip(got, ref):
        assert_close(g.numpy(), np.asarray(r), MODEL_TOL)


@pytest.mark.parametrize("case", ["2d", "3d", "3d_conv3", "2d_cli_width"])
def test_round_trip_through_the_jax_converter(case):
    if case == "2d_cli_width":
        kw = dict(num_classes=14, ndim=2, num_pool=5)
        jm, tm = jgu.GenericUNet(**kw), tgu.GenericUNet(**kw)
        x = np.zeros((1, 64, 64, 1), np.float32)
    else:
        jm, tm, x = _case(2 if case == "2d" else 3, "conv3" if "conv3" in case else "plain")
    v = jax_variables(jm, x, seed=3)
    carry(v, tm)
    up = tm.tu[0].weight.detach().numpy()
    kernel = v["params"][f"up{tm.num_pool - 1}"]["kernel"]
    nd = kernel.ndim - 2
    flipped = kernel[(slice(None, None, -1),) * nd].transpose(nd, nd + 1, *range(nd))
    np.testing.assert_array_equal(up, flipped)
    assert_round_trip(lambda sd: jconv.convert_generic_unet(sd, tm.num_pool), v, tm)


def test_a_value_of_the_wrong_shape_raises():
    jm, tm, x = _case(2, "plain")
    v = jax_variables(jm, x)
    v["params"]["dec0"]["block1"]["conv"]["kernel"] = np.zeros((3, 3, 4, 5), np.float32)
    with pytest.raises(ValueError, match="shape"):
        state_dict_from_jax(v, tm)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("pre")
    trainer_path.write_preprocessed(d, cases=3, shape=(20, 40, 36))
    return d


def _argv(folder, out, *extra):
    return ["2d", "d_lka_former_trainer_synapse", "Task002_Synapse", "0",
            "--preprocessed_folder", str(folder), "--output_folder", str(out),
            "--patch_size", "1", "64", "64", "--batches_per_epoch", "1",
            "--val_batches_per_epoch", "1", "--max_epochs", "1", *extra]


def test_run_training_2d_matches_the_jax_trainer(folder, tmp_path):
    seen = {}
    train_batch, evaluate = Trainer3D.train_batch, Trainer3D.evaluate

    def recorded_train(self, batch):
        seen["init"] = {k: t.detach().numpy().copy()
                        for k, t in self.model.state_dict().items()}
        seen["train"] = batch
        loss = train_batch(self, batch)
        seen["train_loss"] = loss
        return loss

    def recorded_eval(self, batch):
        seen["val"] = batch
        metrics = evaluate(self, batch)
        seen["val_loss"] = float(metrics["loss"])
        return metrics

    with mock.patch.object(Trainer3D, "train_batch", recorded_train), \
            mock.patch.object(Trainer3D, "evaluate", recorded_eval):
        trainer = run_training.main([*_argv(folder, tmp_path), "--device", "cpu"])
    assert trainer.step == 1

    jm = jgu.GenericUNet(num_classes=14, ndim=2, num_pool=5, do_ds=True)
    jt = jtrainer.Trainer3D(jm, tmp_path / "jax", None, None, max_num_epochs=1,
                            num_batches_per_epoch=1)
    jt.state = init_train_state(jconv.convert_generic_unet(seen["init"], 5), jt.tx)
    step = jax.jit(jtrainer.make_ds_train_step(jm.apply, jt.tx, 3))
    state, metrics = step(jt.state, jt._to_device_batch(seen["train"]))
    np.testing.assert_allclose(seen["train_loss"], float(metrics["loss"]), rtol=1e-4)
    # JAX validates with its step's metrics, the update dropped
    _, metrics = step(state, jt._to_device_batch(seen["val"]))
    np.testing.assert_allclose(seen["val_loss"], float(metrics["loss"]), rtol=1e-4)


def test_2d_validation_is_refused_by_both_clis(folder, tmp_path):
    with pytest.raises(NotImplementedError, match="-val"):
        run_training.main([*_argv(folder, tmp_path / "port"), "-val", "--device", "cpu"])
    started = []
    init = jaugment.ThreadedAugmenter.__init__

    def recorded(self, *args, **kwargs):
        init(self, *args, **kwargs)
        started.append(self)

    try:
        with mock.patch.object(jaugment.ThreadedAugmenter, "__init__", recorded), \
                pytest.raises(IndexError):  # the 3D sliding window given a 2D patch
            jax_cli.main([*_argv(folder, tmp_path / "jax"), "--patch_size", "1", "32", "32",
                          "-val"])
    finally:  # the JAX CLI leaves its augmenters' threads running
        for gen in started:
            gen.stop()
    assert len(started) == 2
