"""TransUNet against the JAX package on the CPU, and the 2D zoo through its
entry points:

- TransUNet's new mechanisms one by one (the weight-standardised conv,
  the ×2 bilinear upsample with align_corners, the bottleneck, the
  ResNetV2 stem with its padded /4 skip, the ViT block's spatial stream,
  the decoder block) and the model whole at 224², batch 1, narrow widths,
  with and without its sigmoid, and the weight carry both ways;
- one `Trainer2D` step of DAE-LKA (narrow, 224², batch 2, 4 classes)
  against the JAX `Trainer2D`'s: the loss to rtol 1e-4 and each parameter
  tensor's update within ‖Δ‖ ≤ 1e-3·‖update‖ plus the f32 rounding of the
  two p′ (as `test_torch_trainer2d.py`);
- the three CLIs with `--model` on `--device cpu` at 224² (the zoo's
  geometry), batch 2, one epoch of one batch: `train_synapse2d --model
  dae_lka` with the eval hook on an h5 volume, then `test_synapse2d
  --model dae_lka` on its `best_model`; `train_skin --model transunet
  --evaluate`. The registry entries are swapped for narrow widths of the
  same classes (as the JAX package's tests do): parity is held model by
  model above and in the other `test_torch_zoo_*.py`.

Tolerance, f32: max|port − JAX| ≤ 1e-5·max(1, max|JAX|) for a module,
1e-4·max(1, max|JAX|) for a whole model.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deformablelka_tpu.convert import torch_loader as jconv
from deformablelka_tpu.models import dae_lka as jdaelka
from deformablelka_tpu.models import transunet as jtu
from deformablelka_tpu.training import trainer2d as jtd
from deformablelka_tpu_torch import trainer2d_path
from deformablelka_tpu_torch.cli import test_synapse2d, train_skin, train_synapse2d
from deformablelka_tpu_torch.inference.predictor2d import Predictor2D
from deformablelka_tpu_torch.models import dae_lka as tdaelka
from deformablelka_tpu_torch.models import registry
from deformablelka_tpu_torch.models import transunet as ttu
from deformablelka_tpu_torch.training import trainer2d as ttd
from test_torch_maxvit import assert_close, carry, jax_variables
from test_torch_trainer2d import check_updates
from test_torch_zoo_mit import model_case, randn, run_both

torch.set_num_threads(1)
IMG = 224
NARROW_TU = dict(hidden=64, num_layers=2, heads=4, mlp_dim=128, block_units=(1, 1, 1),
                 width_factor=0.5)
NARROW_DAE = dict(dims=(32, 64, 128), layers=(1, 1, 1))


# ------------------------------------------------------------- TransUNet


def test_upsample_and_std_conv_match_jax():
    x = randn(2, 7, 5, 3, seed=1)
    assert_close(ttu.upsample_bilinear2x(torch.from_numpy(x)).numpy(),
                 np.asarray(jtu.upsample_bilinear2x(jnp.asarray(x))), 1e-6)
    for k, stride in ((1, 1), (3, 2), (7, 2)):
        run_both(jtu.StdConv2d(16, k, stride), ttu.StdConv2d(8, 16, k, stride),
                 randn(1, 15, 15, 8, seed=k))


@pytest.mark.parametrize("cin,stride", [(32, 1), (16, 2)])
def test_bottleneck_matches_jax(cin, stride):
    run_both(jtu.PreActBottleneck(32, 32, stride), ttu.PreActBottleneck(cin, 32, 32, stride),
             randn(1, 14, 14, cin, seed=2))


def test_resnet_v2_pads_its_skip_and_matches_jax():
    jm, tm = jtu.ResNetV2((1, 1, 1), 0.5), ttu.ResNetV2((1, 1, 1), 0.5)
    run_both(jm, tm, randn(1, IMG, IMG, 3, seed=3), rel=1e-4)
    with torch.no_grad():
        _, skips = tm(torch.zeros(1, IMG, IMG, 3))
    assert [tuple(s.shape) for s in skips] == [(1, 28, 28, 256), (1, 56, 56, 128),
                                               (1, 112, 112, 32)]


def test_vit_block_and_decoder_block_match_jax():
    run_both(jtu.ViTBlock(64, 4, 128), ttu.Block(64, 4, 128), randn(2, 49, 64, seed=4))
    run_both(jtu.DecoderBlock(32), ttu.DecoderBlock(24, 16, 40, 32),
             randn(1, 7, 7, 24, seed=5), randn(1, 14, 14, 16, seed=6),
             randn(1, 7, 7, 40, seed=7))


@pytest.mark.parametrize("sigmoid", [False, True])
def test_transunet_matches_jax_and_round_trips(sigmoid):
    model_case(jtu.TransUNet(num_classes=2, apply_sigmoid=sigmoid, **NARROW_TU),
               ttu.TransUNet(2, apply_sigmoid=sigmoid, **NARROW_TU), jconv.convert_transunet,
               channels=3)


# ------------------------------------------------------- a DAE-LKA step


def test_dae_lka_trainer2d_step_matches_jax(tmp_path):
    jm = jdaelka.DAELKAFormer(num_classes=4, **NARROW_DAE)
    tm = tdaelka.DAELKAFormer(4, **NARROW_DAE)
    batch = trainer2d_path.synthetic_batch(0, batch=2, img=IMG, num_classes=4)
    v = jax_variables(jm, batch["image"][:1], seed=5)
    carry(v, tm)
    init = {k: t.clone() for k, t in tm.state_dict().items()}

    jt = jtd.Trainer2D(jm, tmp_path / "jax", None, max_epochs=1, iterations_per_epoch=4)
    jt.initialize(batch)
    jt.state = jt.state._replace(params=jax.tree_util.tree_map(jnp.asarray, v["params"]))
    jt.state, m = jt._step_fn(jt.state, {"image": jnp.asarray(batch["image"]),
                                         "label": jnp.asarray(batch["label"])})

    tt = ttd.Trainer2D(tm, tmp_path / "port", None, max_epochs=1, iterations_per_epoch=4)
    tt.initialize()
    loss = float(tt.train_step(batch))
    np.testing.assert_allclose(loss, float(m["loss"]), rtol=1e-4)
    check_updates(jt.state.params, tt.model, init)


# ------------------------------------------------------------- the CLIs


def _narrow(cls, **kw):
    return lambda num_classes, img_size: cls(num_classes, **kw)


@pytest.fixture(scope="module")
def zoo_synapse_run(tmp_path_factory):
    h5py = pytest.importorskip("h5py")
    tmp = tmp_path_factory.mktemp("zoo_cli")
    trainer2d_path.write_slices(tmp / "npz", tmp / "lists", n=2, size=96)
    cases = trainer2d_path.volumes(1, (2, 96, 96))
    (tmp / "vol").mkdir()
    for image, label, name in cases:
        with h5py.File(tmp / "vol" / f"{name}.npy.h5", "w") as f:
            f["image"] = image
            f["label"] = label.astype(np.uint8)
    (tmp / "lists" / "test_vol.txt").write_text("\n".join(n for _, _, n in cases) + "\n")
    with mock.patch.dict(registry.MODELS_2D,
                         {"dae_lka": _narrow(tdaelka.DAELKAFormer, **NARROW_DAE)}):
        trainer = train_synapse2d.main(trainer2d_path.synapse_argv(
            tmp / "npz", tmp / "lists", tmp / "out", "--volume_path", str(tmp / "vol"),
            "--model", "dae_lka", img=IMG, batch=2, epochs=1, device="cpu"))
        per_case = test_synapse2d.main([
            "--volume_path", str(tmp / "vol"), "--list_dir", str(tmp / "lists"),
            "--output_dir", str(tmp / "out"), "--model", "dae_lka",
            "--num_classes", str(trainer2d_path.NUM_CLASSES), "--device", "cpu"])
    return cases, trainer, per_case


def test_train_synapse2d_with_a_zoo_model(zoo_synapse_run):
    _, trainer, _ = zoo_synapse_run
    assert isinstance(trainer.model, tdaelka.DAELKAFormer)
    assert trainer.step == 1 and np.all(np.isfinite(trainer.losses))
    (epoch, dice), = trainer.eval_results
    assert epoch == 1 and 0.0 <= dice <= 1.0
    assert (trainer.output_folder / "ckpt" / "best_model").is_dir()


def test_test_synapse2d_reads_the_zoo_checkpoint(zoo_synapse_run):
    cases, trainer, per_case = zoo_synapse_run
    pred = Predictor2D(trainer.model, (IMG, IMG), trainer2d_path.NUM_CLASSES, device="cpu")
    for (image, _, name), (got_name, dice, hd, labels) in zip(cases, per_case):
        assert got_name == name and np.isfinite(dice)
        np.testing.assert_array_equal(labels, pred.predict_volume(image))


def test_train_skin_with_transunet(tmp_path):
    root = trainer2d_path.write_skin(tmp_path / "data", (2, 1, 1), size=IMG)
    with mock.patch.dict(registry.MODELS_2D, {"transunet": lambda num_classes, img_size:
                                              ttu.TransUNet(num_classes, img_size,
                                                            apply_sigmoid=False,
                                                            **NARROW_TU)}):
        trainer = train_skin.main(trainer2d_path.skin_argv(
            root, tmp_path / "out", "--model", "transunet", img=IMG, batch=2, epochs=1,
            device="cpu"))
    assert isinstance(trainer.model, ttu.TransUNet) and not trainer.model.apply_sigmoid
    assert np.isfinite(trainer.best_val_loss) and (tmp_path / "out" / "best_model").is_dir()
    best = trainer.test_metrics["best"]
    assert all(np.isfinite(best[k]) for k in ("dsc", "accuracy"))
