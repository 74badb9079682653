"""The Pancreas baselines of the port (VNet, the ResNet34 seg net, UNETR)
against the JAX package's, on the CPU in float32.

- Each model at 32³, batch 1, on the same seeded variables (JAX's from
  `jax.eval_shape` and seeded numpy, `test_torch_maxvit.jax_variables`,
  carried into the port by `state_dict_from_jax`): VNet with 4 filters
  (instance norm, and batch norm with running statistics), `Resnet34Seg`
  at its full width 16 (batch norms on their statistics), UNETR with
  hidden 48, 4 heads, MLP 96, feature size 4 and all 12 blocks.
  Tolerance: max|port − JAX| ≤ 1e-4·max(1, max|JAX|); a VNet decoder
  stage alone (up-block and conv block, with each of the four norms) at
  1e-5·max(1, max|JAX|).
- The weight carry both ways: the JAX package's converters of upstream
  state_dicts (`convert_vnet`, `convert_resnet34`, `convert_unetr`) run
  on the port's `state_dict()` give back exactly the variables it was
  filled from; a value of the wrong shape raises.
- One `TrainerPancreas` run of 2 iterations with VNet (4 filters, 32³,
  batch 2, labeled_bs 1, instance norm as the registry builds it)
  against JAX's, fed the same crops: the losses to rtol 1e-4, the
  tolerance of tests/test_torch_trainer_pancreas.py. Each parameter
  tensor's update is held against the same two iterations of the port
  in float64 within ‖Δ‖ ≤ 1e-3 · ‖update‖ plus the f32 rounding of p′
  (2⁻²³ · ‖p′‖), that file's update tolerance; JAX's update is held
  against the float64 one at 5e-2 · ‖update‖ (`JAX_UPDATE_TOL`: the JAX
  step's float32 reductions in VNet's instance norms put it 1-3 % off).
- `train_pancreas --model vnet`, then `test_pancreas --model vnet` on the
  checkpoint it wrote, at 32³ on a one-case h5 fold (h5py): the metrics
  equal those of the tester on the trained model.

`build_pancreas_model` for all five names is held in
tests/test_torch_pancreas_tester.py.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deformablelka_tpu.convert import torch_loader as jconv
from deformablelka_tpu.models import pancreas_baselines as jpb
from deformablelka_tpu.training import trainer_pancreas as jtp
from deformablelka_tpu_torch import case_path, trainer_path
from deformablelka_tpu_torch.cli import test_pancreas as test_cli
from deformablelka_tpu_torch.cli import train_pancreas as train_cli
from deformablelka_tpu_torch.convert.jax_params import state_dict_from_jax
from deformablelka_tpu_torch.inference import pancreas as tpan
from deformablelka_tpu_torch.models import pancreas_baselines as tpb
from deformablelka_tpu_torch.training import trainer_pancreas as ttp

from test_torch_maxvit import assert_close, carry, jax_variables
from test_torch_zoo_mit import assert_round_trip

torch.set_num_threads(1)
PATCH = (32, 32, 32)
MODULE_TOL, MODEL_TOL = 1e-5, 1e-4
# the JAX step's own f32 error on VNet's updates: its instance norms'
# float32 reductions over 32³ voxels (block_one's output is 3e-5 off a
# float64 evaluation in JAX, 2e-7 in the port) grow to 1-3 % of the
# update per tensor through the backward pass
JAX_UPDATE_TOL = 5e-2
UNETR_SMALL = dict(img_size=PATCH, hidden=48, heads=4, mlp_dim=96, feature_size=4)

MODELS = {
    "vnet": (lambda: jpb.VNet(n_classes=2, n_filters=4),
             lambda: tpb.VNet(n_classes=2, n_filters=4),
             lambda sd: jconv.convert_vnet(sd, normalization="instancenorm")),
    "vnet_batchnorm": (
        lambda: jpb.VNet(n_classes=2, n_filters=4, normalization="batchnorm"),
        lambda: tpb.VNet(n_classes=2, n_filters=4, normalization="batchnorm"),
        lambda sd: jconv.convert_vnet(sd, normalization="batchnorm")),
    "resnet34": (lambda: jpb.Resnet34Seg(n_classes=2),
                 lambda: tpb.Resnet34Seg(n_classes=2),
                 jconv.convert_resnet34),
    "unetr": (lambda: jpb.UNETR(n_classes=2, **UNETR_SMALL),
              lambda: tpb.UNETR(n_classes=2, **UNETR_SMALL),
              jconv.convert_unetr),
}


def volume(seed=1, batch=1):
    return np.random.RandomState(seed).randn(batch, *PATCH, 1).astype(np.float32)


@pytest.fixture(scope="module")
def carried():
    """name → (JAX variables, JAX output, carried port model, input)."""
    cache = {}

    def get(name):
        if name not in cache:
            make_jax, make_port, _ = MODELS[name]
            jm, x = make_jax(), volume()
            v = jax_variables(jm, x)
            ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
            cache[name] = (v, ref, carry(v, make_port()), x)
        return cache[name]
    return get


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_matches_jax(carried, name):
    _, ref, tm, x = carried(name)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (1, *PATCH, 2)
    assert_close(got, ref, MODEL_TOL)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_round_trip_through_the_jax_converter(carried, name):
    v, _, tm, _ = carried(name)
    assert_round_trip(MODELS[name][2], v, tm)


@pytest.mark.parametrize("norm", ["instancenorm", "batchnorm", "groupnorm", "none"])
def test_vnet_decoder_stage_matches_jax(norm):
    """UpBlock (flax's ConvTranspose: the JAX kernel is flipped) then a
    three-stage ConvBlock, alone, with each of the four norms."""
    x = np.random.RandomState(3).randn(1, 8, 8, 8, 32).astype(np.float32)
    up_j, up_t = jpb.UpBlock(16, 2, norm), tpb.UpBlock(32, 16, 2, norm)
    v = jax_variables(up_j, x, seed=4)
    ref = np.array(up_j.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = carry(v, up_t)(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 16, 16, 16, 16)
    assert_close(got, ref, MODULE_TOL)
    block_j, block_t = jpb.ConvBlock(3, 16, norm), tpb.ConvBlock(3, 16, 16, norm)
    v = jax_variables(block_j, ref, seed=5)
    want = np.asarray(block_j.apply(v, jnp.asarray(ref)))
    with torch.no_grad():
        assert_close(carry(v, block_t)(torch.from_numpy(ref)).numpy(), want, MODULE_TOL)


def test_a_value_of_the_wrong_shape_raises(carried):
    v, _, _, _ = carried("vnet")
    bad = jax.tree_util.tree_map(np.copy, v)
    k = bad["params"]["block_five_up"]["conv"]["kernel"]
    bad["params"]["block_five_up"]["conv"]["kernel"] = k[:, :, :, :-1]
    with pytest.raises(ValueError, match="shape"):
        state_dict_from_jax(bad, tpb.VNet(n_classes=2, n_filters=4))


class _Float64(torch.nn.Module):
    """The model in float64 behind a float32 interface."""

    def __init__(self, model):
        super().__init__()
        self.model = model.double()

    def forward(self, x):
        return self.model(x.double())


def _run_port(model, tmp, shape):
    init = {k: t.clone().double() for k, t in model.state_dict().items()}
    trainer = ttp.TrainerPancreas(model, tmp, max_iterations=2, batch_size=2,
                                  labeled_bs=1)
    rec = []
    trainer.run_training(trainer_path.pancreas_loader(0, shape, PATCH), log_every=0,
                         callback=lambda it, m, metrics: rec.append(
                             [float(metrics[k]) for k in ("loss", "loss_seg",
                                                          "loss_seg_dice")]))
    assert trainer.step == 2
    return rec, {k: t.double() - init[k] for k, t in model.state_dict().items()}


def test_trainer_pancreas_with_vnet_matches_jax(tmp_path):
    shape = (40, 36, 24)
    jm = jpb.VNet(n_classes=2, n_filters=4)
    v = jax_variables(jm, np.zeros((2, *PATCH, 1), np.float32), seed=5)
    tm = carry(v, tpb.VNet(n_classes=2, n_filters=4))
    init = {k: t.clone() for k, t in tm.state_dict().items()}

    jt = jtp.TrainerPancreas(jm, tmp_path / "jax", max_iterations=2, batch_size=2,
                             labeled_bs=1)
    v_jnp = jax.tree_util.tree_map(jnp.asarray, v)
    with mock.patch.object(type(jm), "init", lambda self, rng, x: v_jnp):
        jt.initialize({"data": np.zeros((2, *PATCH, 1), np.float32)})
    jrec = []
    jt.run_training(trainer_path.pancreas_loader(0, shape, PATCH), log_every=0,
                    callback=lambda it, s, m: jrec.append(
                        [float(m[k]) for k in ("loss", "loss_seg", "loss_seg_dice")]))
    trec, tupd = _run_port(tm, tmp_path / "port", shape)
    assert len(trec) == len(jrec) == 2
    np.testing.assert_allclose(trec, jrec, rtol=1e-4)

    # the same two iterations in float64: the port's updates to 1e-3
    _, exact = _run_port(_Float64(carry(v, tpb.VNet(n_classes=2, n_filters=4))),
                         tmp_path / "f64", shape)
    jupd = {k: t.double() - init[k].double() for k, t in state_dict_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, jt.state.params)}, tm).items()}
    after = tm.state_dict()
    assert sorted(jupd) == sorted(tupd) == sorted(k[len("model."):] for k in exact)
    for k in tupd:
        want = exact["model." + k]
        f32 = 2 ** -23 * after[k].double().norm()
        assert (tupd[k] - want).norm() <= 1e-3 * want.norm() + f32, k
        assert (jupd[k] - want).norm() <= JAX_UPDATE_TOL * want.norm() + f32, k


def test_train_and_test_pancreas_clis_with_vnet(tmp_path):
    h5py = pytest.importorskip("h5py")
    name, image, label = case_path.pancreas_case(seed=2, shape=(40, 36, 24))
    (tmp_path / "Pancreas" / "Flods").mkdir(parents=True)
    with h5py.File(tmp_path / f"{name}.h5", "w") as f:
        f["image"], f["label"] = image, label.astype(np.uint8)
    for fold in ("train0.list", "test0.list"):
        (tmp_path / "Pancreas" / "Flods" / fold).write_text(f"{name}.h5\n")
    common = ["--root_path", str(tmp_path), "--patch_size", *map(str, PATCH),
              "--model", "vnet", "--device", "cpu"]
    trainer = train_cli.main([*common, "--output_dir", str(tmp_path / "model"),
                              "--max_iterations", "2"])
    run_dir = tmp_path / "model" / "pancreas_dlka"
    assert isinstance(trainer.model, tpb.VNet) and trainer.step == 2
    assert (run_dir / "d_lka_former_iter_2").is_dir()
    avg = test_cli.main([*common, "--model_dir", str(run_dir),
                         "--checkpoint", "d_lka_former_iter_2"])
    sw = tpan.make_pancreas_sliding_window(trainer.model.eval(), patch_size=PATCH,
                                           device="cpu")
    np.testing.assert_array_equal(
        avg, tpan.test_all_case(sw, [(name, image, label)], verbose=False))
    assert np.all(np.isfinite(avg)) and 0 <= avg[0] <= 1
