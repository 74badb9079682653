"""The port's Synapse prediction CLI against the JAX package's, and the
port's checkpoints and restore manifest, on the CPU.

`cli.predict_simple.main` of both packages runs on the same folder of two
small CT-like NIfTI cases (each resampled to one 16×32×32 tile), with two
folds of `dlka_former_synapse` at patch (16, 32, 32) and mirroring off:
the JAX CLI from Orbax checkpoints of seeded JAX variables, the port's
(`--device cpu`) from its own `torch.save` checkpoints of the same
variables carried by `state_dict_from_jax`. Tolerances: the fold-averaged
probabilities that each CLI restores at atol 1e-4, rtol 1e-4; the
written labels exactly wherever the top two of the JAX package's
restored probabilities differ by more than 1e-4; shape, affine and dtype
of every written file exactly.

Then the port's `CheckpointManager` (save, load, bookkeeping, exists,
async saves, scheduled saves and their GC, `should_save_scheduled`
against the JAX package's) and `model_restore` (manifest, restore, one
model per fold), exactly.
"""

import json
import pickle
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deformablelka_tpu.cli import predict_simple as jcli
from deformablelka_tpu.inference import predictor3d as jp3
from deformablelka_tpu.models.dlka_former import dlka_former_synapse as jax_synapse
from deformablelka_tpu.training import checkpoint as jckpt
from deformablelka_tpu_torch import case_path
from deformablelka_tpu_torch.cli import predict_simple as tcli
from deformablelka_tpu_torch.convert.jax_params import state_dict_from_jax
from deformablelka_tpu_torch.data import nifti
from deformablelka_tpu_torch.inference import model_restore
from deformablelka_tpu_torch.inference import predictor3d as tp3
from deformablelka_tpu_torch.models.dlka_former import dlka_former_synapse, dlka_net_pancreas
from deformablelka_tpu_torch.training import checkpoint as tckpt

from test_torch_block_variants import jax_variables
from test_torch_predictor3d import _restored_softmax

torch.set_num_threads(1)
IMG = (16, 32, 32)


def _write_runs(tmp_path):
    """Two folds of seeded JAX variables: an Orbax run for the JAX CLI and
    a port run of the same weights."""
    x = np.zeros((1, *IMG, 1), np.float32)
    jm = jax_synapse(num_classes=14, do_ds=False, img_size=IMG)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    tm = dlka_former_synapse(14, do_ds=False, img_size=IMG, device="cpu")
    for fold, seed in ((0, 0), (1, 1)):
        v = jax_variables(jm, x, seed, shapes=shapes)
        jckpt.CheckpointManager(tmp_path / "jax_run" / f"fold_{fold}" / "ckpt",
                                async_save=False).save(case_path.CHECKPOINT, v)
        # a synchronous save: the CLI reads the run through managers of its own
        tckpt.CheckpointManager(tmp_path / "port_run" / f"fold_{fold}" / "ckpt",
                                async_save=False).save(
            case_path.CHECKPOINT, {"model": state_dict_from_jax(v, tm)})


def test_predict_simple_matches_the_jax_cli(tmp_path):
    for seed in (0, 1):
        case_path.write_case(tmp_path / "in", seed=seed, name=f"case_{seed:03d}.nii.gz",
                             shape=(13, 27, 27))
    _write_runs(tmp_path)
    argv = lambda run, out: [*case_path.predict_simple_argv(
        tmp_path / "in", tmp_path / out, tmp_path / run, patch=IMG)[:-2], "--disable_tta"]
    with mock.patch.object(jp3, "restore_softmax_to_original",
                           wraps=jp3.restore_softmax_to_original) as jrestore:
        jcli.main(argv("jax_run", "jax_out"))
    with mock.patch.object(tp3, "restore_softmax_to_original",
                           wraps=tp3.restore_softmax_to_original) as trestore:
        predictor = tcli.main(argv("port_run", "port_out") + ["--device", "cpu"])
    assert predictor.last_case["tiles"] == 1
    assert predictor.last_case["preprocessed_shape"] == IMG
    assert len(jrestore.call_args_list) == len(trestore.call_args_list) == 2
    for seed, jcall, tcall in zip((0, 1), jrestore.call_args_list, trestore.call_args_list):
        (jprobs, jprops), (tprobs, tprops) = jcall.args, tcall.args
        assert tprops == jprops
        np.testing.assert_allclose(tprobs, jprobs, atol=1e-4, rtol=1e-4)
        name = f"case_{seed:03d}.nii.gz"
        src, got, ref = (nifti.load(tmp_path / d / name) for d in ("in", "port_out", "jax_out"))
        assert got.data.dtype == ref.data.dtype == np.uint8
        assert got.data.shape == ref.data.shape == src.data.shape
        np.testing.assert_array_equal(got.affine, src.affine)
        np.testing.assert_array_equal(got.affine, ref.affine)
        top2 = np.sort(_restored_softmax(jprobs, jprops), axis=-1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > 1e-4
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(got.data[clear], ref.data[clear])
        assert len(np.unique(ref.data)) > 3


def _state(seed):
    g = torch.Generator().manual_seed(seed)
    model = torch.nn.Linear(3, 2)
    with torch.no_grad():
        model.weight.copy_(torch.randn(2, 3, generator=g))
        model.bias.copy_(torch.randn(2, generator=g))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9, nesterov=True)
    model(torch.randn(4, 3, generator=g)).sum().backward()
    opt.step()
    return {"model": model.state_dict(), "optimizer": opt.state_dict(), "epoch": seed,
            "best": [0.5, float(seed)], "name": "run"}


def _assert_state_equal(got, ref):
    if isinstance(ref, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert torch.equal(got, ref)
    elif isinstance(ref, dict):
        assert sorted(got) == sorted(ref)
        for k in ref:
            _assert_state_equal(got[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            _assert_state_equal(a, b)
    else:
        assert got == ref


@pytest.mark.parametrize("async_save", [True, False])
def test_checkpoint_manager_round_trip(tmp_path, async_save):
    mgr = tckpt.CheckpointManager(tmp_path / "ckpt", async_save=async_save,
                                  max_scheduled_keep=2)
    state = _state(0)
    mgr.save("model_latest", state, {"epoch": 3, "val": np.float32(0.25)})
    state["model"]["weight"].add_(1.0)  # the saved copy is unaffected
    assert mgr.exists("model_latest") and not mgr.exists("model_best")
    got, meta = mgr.load("model_latest")
    _assert_state_equal(got, _state(0))
    assert meta == {"epoch": 3, "val": 0.25}
    assert json.loads((tmp_path / "ckpt" / "model_latest.json").read_text()) == meta
    assert (tmp_path / "ckpt" / "model_latest" / tckpt.STATE_FILE).is_file()
    mgr.save("model_latest", _state(1))  # overwrite, no bookkeeping
    _assert_state_equal(mgr.load("model_latest")[0], _state(1))
    for epoch in (5, 10, 15, 20):
        mgr.save_scheduled(epoch, _state(epoch), {"epoch": epoch})
    assert mgr.scheduled_epochs() == [15, 20]
    assert not (tmp_path / "ckpt" / "model_ep_005.json").exists()
    assert not (tmp_path / "ckpt" / "model_ep_010").exists()
    _assert_state_equal(mgr.load("model_ep_020")[0], _state(20))
    assert mgr.load("model_ep_015")[1] == {"epoch": 15}
    mgr.wait_until_finished()


def test_checkpoint_load_refuses_pickled_objects(tmp_path):
    mgr = tckpt.CheckpointManager(tmp_path, async_save=False)
    mgr.save("odd", {"model": {}, "fn": mock.sentinel.obj})
    with pytest.raises(pickle.UnpicklingError):
        mgr.load("odd")


def test_async_save_error_surfaces_at_the_next_join(tmp_path):
    mgr = tckpt.CheckpointManager(tmp_path)
    with mock.patch.object(tckpt.torch, "save", side_effect=OSError("disk full")):
        mgr.save("model_latest", _state(0))
        with pytest.raises(OSError):
            mgr.wait_until_finished()
    mgr.wait_until_finished()  # the error is raised once


def test_save_schedule_matches_jax():
    for epoch in range(0, 1200, 7):
        for every, warm in ((50, 400), (1, 0), (10, 20)):
            assert tckpt.should_save_scheduled(epoch, every, warm) == \
                jckpt.should_save_scheduled(epoch, every, warm)


def test_model_restore_round_trip(tmp_path):
    kwargs = {"num_classes": 2, "img_size": [32, 32, 32],
              "trans_block": "TransformerBlock_SE"}
    for fold in (0, 1):
        run = tmp_path / f"fold_{fold}"
        cfg = model_restore.save_model_config(run, "dlka_net_pancreas", kwargs, (32, 32, 32, 1))
        assert json.loads((run / model_restore.MODEL_CONFIG).read_text()) == cfg
        model = dlka_net_pancreas(2, img_size=(32, 32, 32), trans_block="TransformerBlock_SE",
                                  seed=fold + 5, device="cpu")
        # a synchronous save: `restore_model` reads through a manager of its own
        tckpt.CheckpointManager(run, async_save=False).save(
            "model_final_checkpoint", {"model": model.state_dict(), "epoch": 1})
    model, sd = model_restore.restore_model(tmp_path / "fold_1", device="cpu")
    assert not model.training
    assert sum(type(m).__name__ == "TransformerBlock_SE" for m in model.modules()) == 21
    ref = dlka_net_pancreas(2, img_size=(32, 32, 32), trans_block="TransformerBlock_SE",
                            seed=6, device="cpu").state_dict()
    _assert_state_equal(sd, ref)
    _assert_state_equal(model.state_dict(), ref)
    models = model_restore.load_model_and_checkpoint_files(tmp_path, folds=(0, 1),
                                                           device="cpu")
    assert len(models) == 2
    assert not torch.equal(models[0].out1.conv.conv.weight, models[1].out1.conv.conv.weight)
    _assert_state_equal(models[1].state_dict(), ref)
