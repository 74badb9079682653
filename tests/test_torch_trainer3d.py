"""The port's `Trainer3D` (and its `make_ds_train_step`) against the JAX
package's, on the CPU in float32.

Both trainers start from the same variables (JAX's from `jax.eval_shape`
and seeded numpy, carried into the port by `state_dict_from_jax`) and are
fed the same batches: one seeded synchronous generator per trainer, the
CLI's loader then augmenter (`run_training.make_pipeline`, moreDA for
training) in the caller's thread, so that no thread decides their order.

- `dlka_former_synapse(14, do_ds=True)` at img (16, 32, 32) with
  `trans_block="TransformerBlock_SE"` (the D-LKA block's step, and that
  remat leaves the gradients as they are, are held by
  tests/test_torch_train_step.py; the JAX step's compile with that block
  takes minutes here), remat off and batch 1 (the JAX step's compile and
  steps set this file's time), 2 epochs of 2 training and 1 validation batches: the
  per-step losses to rtol 1e-4, the LR of every step (a function of the
  update count) to rtol 1e-6, the validation losses to rtol 1e-4, their
  tp/fp/fn up to the voxels whose top two logits tie to 1e-4 (each may
  take the other class in the other framework: 4 counts at most), the
  global Dice that they give to 1e-3, and each parameter tensor's
  update p' − p over the run within ‖Δ‖ ≤ 1e-3 · ‖update‖ (as in
  tests/test_torch_train_step.py) plus the f32 rounding of the two p′
  (2⁻²³ · ‖p′‖); the checkpoints and logs written.
- A one-layer model (a per-voxel linear map to 14 classes, its deep-
  supervision heads strided views) for what needs many steps: the LR of
  every epoch through a forced fallback at epoch 100 (momentum 0.95, a
  fresh optimizer, the count and so the LR back at the start), the
  checkpoint files and bookkeeping of the scheduled-save policy against
  JAX's, a `load_checkpoint` round trip, and `find_lr` (log LRs equal,
  smoothed losses to rtol 1e-5). The one-layer model's losses agree to
  rtol 1e-4 over its runs (its Dense and Linear round apart).
"""

import json
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deformablelka_tpu.models.dlka_former import dlka_former_synapse as jax_synapse
from deformablelka_tpu.training import trainer3d as jtrainer
from deformablelka_tpu.training.train_step import init_train_state
from deformablelka_tpu_torch import trainer_path
from deformablelka_tpu_torch.cli import run_training
from deformablelka_tpu_torch.convert.jax_params import state_dict_from_jax
from deformablelka_tpu_torch.data.dataset import load_dataset
from deformablelka_tpu_torch.models.dlka_former import dlka_former_synapse
from deformablelka_tpu_torch.training import trainer3d

from test_torch_block_variants import jax_variables

torch.set_num_threads(1)
IMG = (16, 32, 32)
BLOCK = "TransformerBlock_SE"


class SyncGen:
    """The CLI's loader, then its augmentation, in the caller's thread."""

    def __init__(self, loader, transform):
        self.loader, self.transform = loader, transform

    def next(self):
        return self.transform(self.loader.next())


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("pre")
    trainer_path.write_preprocessed(d, cases=3, shape=(20, 40, 36))
    return d


def _gens(folder, batch_size=2):
    """(train, val) generators with the CLI's seeds."""
    train, val = run_training.split_cases(load_dataset(folder))
    scales = run_training.deep_supervision_scales((2, 4, 4))
    return [SyncGen(*run_training.make_pipeline(ds, IMG, batch_size, seed, is_train,
                                                "moreDA", scales))
            for ds, seed, is_train in ((train, 1234, True), (val, 5678, False))]


def _opt_count(state) -> int:
    return int(optax.tree_utils.tree_get(state.opt_state, "count"))


def _record_jax(trainer, step_fn):
    """Route the JAX trainer's steps through `step_fn`, recording (count,
    LR, loss, tp, fp, fn) of each call."""
    calls = []

    def recorded(state, batch):
        count = _opt_count(state)
        new, m = step_fn(state, batch)
        calls.append((count, float(trainer._lr_schedule(count)), float(m["loss"]),
                      *(np.asarray(m[k]) for k in ("tp", "fp", "fn"))))
        return new, m

    trainer._step_fn = recorded
    return calls


def _record_port(trainer):
    """(steps, val batches) of the port trainer: (count, LR, loss) and
    (loss, tp, fp, fn)."""
    steps, vals = [], []
    step_fn, evaluate = trainer._step_fn, trainer.evaluate

    def step(batch, lr):
        count = trainer.step
        m = step_fn(batch, lr)
        steps.append((count, lr, float(m["loss"])))
        return m

    def evaluated(batch):
        m = evaluate(batch)
        with torch.no_grad():
            logits = trainer.model(trainer._to_device_batch(batch)["data"])[0]
        top2 = logits.topk(2, dim=-1).values
        near = int(((top2[..., 0] - top2[..., 1]) <= 1e-4 * logits.abs().max()).sum())
        vals.append((float(m["loss"]), near, *(m[k].numpy() for k in ("tp", "fp", "fn"))))
        return m

    trainer._step_fn, trainer.evaluate = step, evaluated
    return steps, vals


@pytest.fixture(scope="module")
def synapse_runs(folder, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("runs")
    jm = jax_synapse(num_classes=14, do_ds=True, trans_block=BLOCK, deterministic=True,
                     img_size=IMG)
    v = jax_variables(jm, np.zeros((1, *IMG, 1), np.float32), seed=3)
    tm = dlka_former_synapse(14, do_ds=True, img_size=IMG, trans_block=BLOCK, device="cpu")
    tm.load_state_dict(state_dict_from_jax(v, tm), strict=True)
    init = {k: t.clone() for k, t in tm.state_dict().items()}
    kw = dict(max_num_epochs=2, num_batches_per_epoch=2, num_val_batches_per_epoch=1)

    jt = jtrainer.Trainer3D(jm, tmp / "jax", *_gens(folder, 1), **kw)
    jt.state = init_train_state(jax.tree_util.tree_map(jnp.asarray, v), jt.tx)
    jcalls = _record_jax(jt, jax.jit(jtrainer.make_ds_train_step(jm.apply, jt.tx, 3)))
    jt.run_training()

    tt = trainer3d.Trainer3D(tm, tmp / "port", *_gens(folder, 1), **kw)
    tt.initialize()
    tsteps, tvals = _record_port(tt)
    tt.run_training()
    return dict(jt=jt, jcalls=jcalls, tt=tt, tsteps=tsteps, tvals=tvals, v=v, init=init)


def test_steps_and_lr_match_jax(synapse_runs):
    r = synapse_runs
    jtrain = [c for i, c in enumerate(r["jcalls"]) if i % 3 != 2]  # 2 steps, 1 val
    assert [c[0] for c in jtrain] == [c[0] for c in r["tsteps"]] == [0, 1, 2, 3]
    np.testing.assert_allclose([c[1] for c in r["tsteps"]], [c[1] for c in jtrain],
                               rtol=1e-6)
    np.testing.assert_allclose([c[2] for c in r["tsteps"]], [c[2] for c in jtrain],
                               rtol=1e-4)
    assert r["tt"].step == _opt_count(r["jt"].state) == 4
    np.testing.assert_allclose(r["tt"].all_tr_losses, r["jt"].all_tr_losses, rtol=1e-4)


def test_validation_matches_jax_without_an_update(synapse_runs):
    r = synapse_runs
    jval = [c for i, c in enumerate(r["jcalls"]) if i % 3 == 2]
    assert len(jval) == len(r["tvals"]) == 2
    for (tl, near, *tcounts), (_, _, jl, *jcounts) in zip(r["tvals"], jval):
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        # a voxel whose top two logits tie to 1e-4 may take the other class
        # in the other framework: it moves tp/fp/fn by at most 4 in all
        l1 = sum(np.abs(t - j).sum() for t, j in zip(tcounts, jcounts))
        assert l1 <= 4 * near, (l1, near)
    np.testing.assert_allclose(r["tt"].all_val_losses, r["jt"].all_val_losses, rtol=1e-4)
    np.testing.assert_allclose(r["tt"].all_val_eval_metrics, r["jt"].all_val_eval_metrics,
                               rtol=0, atol=1e-3)


def test_updates_match_jax(synapse_runs):
    r = synapse_runs
    tm = r["tt"].model
    ref = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, r["jt"].state.params),
                               "batch_stats": r["v"]["batch_stats"]}, tm)
    after = tm.state_dict()
    assert sorted(ref) == sorted(after)
    moved = 0
    for k in ref:
        want, got = ref[k] - r["init"][k], after[k] - r["init"][k]
        # the stored p' of each framework is rounded to f32: up to half an
        # ulp per element each, which a small update of a large parameter
        # (a norm's scale near 1 under weight decay) can reach
        assert (got - want).norm() <= 1e-3 * want.norm() + 2 ** -23 * after[k].norm(), k
        moved += bool(want.norm() > 0)
    assert moved == len(dict(tm.named_parameters()))


def test_checkpoints_and_logs_written(synapse_runs):
    r = synapse_runs
    tdir, jdir = r["tt"].output_folder, r["jt"].output_folder
    names = lambda d: sorted(p.name for p in (d / "ckpt").iterdir())
    assert names(tdir) == names(jdir) == ["model_best", "model_best.json",
                                          "model_final_checkpoint",
                                          "model_final_checkpoint.json"]
    for name in ("model_best", "model_final_checkpoint"):
        tb = json.loads((tdir / "ckpt" / f"{name}.json").read_text())
        jb = json.loads((jdir / "ckpt" / f"{name}.json").read_text())
        assert sorted(tb) == sorted(jb) and tb["epoch"] == jb["epoch"]
        for k in ("all_tr_losses", "all_val_losses", "all_val_eval_metrics"):
            np.testing.assert_allclose(tb[k], jb[k], rtol=1e-4, atol=1e-6)
    state, book = r["tt"].ckpt.load("model_final_checkpoint")
    assert sorted(state) == ["model", "optimizer", "step"] and state["step"] == 4
    assert book["epoch"] == 2
    for k, t in r["tt"].model.state_dict().items():
        torch.testing.assert_close(state["model"][k], t, rtol=0, atol=0)
    for d in (tdir, jdir):
        assert (d / "progress.png").stat().st_size > 0
        log = (d / "training_log.txt").read_text().splitlines()
        assert len(log) == 2 and "epoch 2 lr" in log[-1]


# ------------------------------------------------ one-layer model, many steps

class JaxTiny(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        y = fnn.Dense(14)(x)
        return [y, y[:, ::2, ::4, ::4], y[:, ::4, ::8, ::8]]


class TorchTiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.dense = torch.nn.Linear(1, 14)

    def forward(self, x):
        y = self.dense(x)
        return [y, y[:, ::2, ::4, ::4], y[:, ::4, ::8, ::8]]


def _tiny_pair(folder, tmp, val=True, **kw):
    """A JAX and a port trainer of the one-layer model from the same
    seeded weights, each with its own generators."""
    rng = np.random.RandomState(11)
    kernel, bias = rng.randn(1, 14).astype(np.float32), rng.randn(14).astype(np.float32)
    jm = JaxTiny()
    gens = _gens(folder)
    jt = jtrainer.Trainer3D(jm, tmp / "jax", gens[0], gens[1] if val else None, **kw)
    jt.state = init_train_state({"params": {"Dense_0": {"kernel": jnp.asarray(kernel),
                                                        "bias": jnp.asarray(bias)}}}, jt.tx)
    jt._step_fn = jax.jit(jtrainer.make_ds_train_step(jm.apply, jt.tx, 3))
    tm = TorchTiny()
    with torch.no_grad():
        tm.dense.weight.copy_(torch.from_numpy(kernel.T))
        tm.dense.bias.copy_(torch.from_numpy(bias))
    gens = _gens(folder)
    tt = trainer3d.Trainer3D(tm, tmp / "port", gens[0], gens[1] if val else None, **kw)
    tt.initialize()
    return jt, tt


def test_lr_of_every_epoch_through_the_fallback(folder, tmp_path):
    """Epochs 97-100 of 101 with a global Dice of 0 over the last 5 epochs:
    at the end of epoch 99 both fall back to momentum 0.95 with a fresh
    optimizer, so the count, and with it the LR, starts again in epoch 100.
    The JAX trainer's steps are recorded up to its fallback, which builds
    a new step; its epochs' losses, count and parameters after."""
    jt, tt = _tiny_pair(folder, tmp_path, val=False, max_num_epochs=101,
                        num_batches_per_epoch=2)
    for t in (jt, tt):
        t.epoch, t.all_val_eval_metrics = 97, [0.0] * 5
    jcalls = _record_jax(jt, jt._step_fn)
    tsteps = []
    make_step = trainer3d.make_ds_train_step

    def recording(model, optimizer, n):
        step = make_step(model, optimizer, n)

        def recorded(batch, lr):
            count = tt.step
            m = step(batch, lr)
            tsteps.append((count, lr, float(m["loss"])))
            return m
        return recorded

    with mock.patch.object(trainer3d, "make_ds_train_step", recording):
        tt.initialize()
        tt.run_training()
    jt.run_training()
    assert [c[0] for c in tsteps] == [0, 1, 2, 3, 4, 5, 0, 1]
    assert [c[0] for c in jcalls] == [0, 1, 2, 3, 4, 5]
    lrs = [c[1] for c in tsteps]
    np.testing.assert_allclose(lrs[:6], [c[1] for c in jcalls], rtol=1e-6)
    expect = [1e-2 * (1 - e / 101) ** 0.9 for e in (0, 0, 1, 1, 2, 2, 0, 0)]
    np.testing.assert_allclose(lrs, expect, rtol=1e-6)
    np.testing.assert_allclose([c[2] for c in tsteps[:6]], [c[2] for c in jcalls],
                               rtol=1e-4)
    np.testing.assert_allclose(tt.all_tr_losses, jt.all_tr_losses, rtol=1e-4)
    assert len(tt.all_tr_losses) == 4
    assert tt.momentum == jt.momentum == tt.optimizer.param_groups[0]["momentum"] == 0.95
    assert tt.step == _opt_count(jt.state) == 2 and tt.epoch == jt.epoch == 101
    dense = jt.state.params["Dense_0"]
    np.testing.assert_allclose(tt.model.dense.weight.detach().numpy().T,
                               np.asarray(dense["kernel"]), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tt.model.dense.bias.detach().numpy(),
                               np.asarray(dense["bias"]), rtol=1e-4, atol=1e-6)


def test_scheduled_saves_and_bookkeeping_match_jax(folder, tmp_path):
    kw = dict(max_num_epochs=4, num_batches_per_epoch=1, num_val_batches_per_epoch=1,
              save_every=1, checkpoint_warmup_epochs=0, max_scheduled_keep=2)
    jt, tt = _tiny_pair(folder, tmp_path, tensorboard_dir=None, **kw)
    jt.run_training()
    tt = trainer3d.Trainer3D(tt.model, tmp_path / "port", *_gens(folder),
                             tensorboard_dir=tmp_path / "tb", **kw)
    tt.run_training()
    names = lambda t: sorted(p.name for p in (t.output_folder / "ckpt").iterdir())
    assert names(tt) == names(jt)
    assert tt.ckpt.scheduled_epochs() == jt.ckpt.scheduled_epochs() == [3, 4]
    assert "model_latest" in names(tt) and "model_best" in names(tt)
    for name in ("model_latest", "model_ep_004", "model_final_checkpoint"):
        tb = json.loads((tt.output_folder / "ckpt" / f"{name}.json").read_text())
        jb = json.loads((jt.output_folder / "ckpt" / f"{name}.json").read_text())
        assert tb["epoch"] == jb["epoch"] and tb["best_val_eval"] == pytest.approx(
            jb["best_val_eval"], abs=1e-6)
        np.testing.assert_allclose(tb["all_tr_losses"], jb["all_tr_losses"], rtol=1e-4)
        np.testing.assert_allclose(tb["all_val_losses"], jb["all_val_losses"], rtol=1e-4)
    assert any(p.name.startswith("events.out.tfevents") for p in (tmp_path / "tb").iterdir())


def test_load_checkpoint_round_trip(folder, tmp_path):
    kw = dict(max_num_epochs=3, num_batches_per_epoch=2, num_val_batches_per_epoch=1)
    _, tt = _tiny_pair(folder, tmp_path, **kw)
    tt.max_num_epochs = 2
    tt.run_training()
    tt.max_num_epochs = 3
    tt.save_checkpoint("model_latest")
    tt.ckpt.wait_until_finished()
    restored = trainer3d.Trainer3D(TorchTiny(), tmp_path / "port", *_gens(folder), **kw)
    restored.load_checkpoint("model_latest")
    assert restored.step == tt.step == 4 and restored.epoch == 2
    assert restored.all_tr_losses == tt.all_tr_losses
    assert restored.all_val_eval_metrics == tt.all_val_eval_metrics
    assert restored.best_val_eval == tt.best_val_eval
    for k, t in tt.model.state_dict().items():
        torch.testing.assert_close(restored.model.state_dict()[k], t, rtol=0, atol=0)
    batch = _gens(folder)[0].next()
    assert restored.train_batch(batch) == tt.train_batch(batch)  # momentum restored
    for k, t in tt.model.state_dict().items():
        torch.testing.assert_close(restored.model.state_dict()[k], t, rtol=0, atol=0)


def test_find_lr_matches_jax(folder, tmp_path):
    jt, tt = _tiny_pair(folder, tmp_path)
    before = {k: t.clone() for k, t in tt.model.state_dict().items()}
    kw = dict(num_iters=8, init_value=1e-3, final_value=30.0)
    jlrs, jlosses = jt.find_lr(**kw)
    tlrs, tlosses = tt.find_lr(**kw, plot_file=tmp_path / "lr.png")
    assert tlrs == jlrs and len(tlrs) >= 4
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    for k, t in before.items():  # the sweep leaves the model as it was
        torch.testing.assert_close(tt.model.state_dict()[k], t, rtol=0, atol=0)
    assert tt.step == 0
