"""The port's 2D trainers against the JAX package's, on the CPU in float32.

The model is small and built from ported 2D modules: a 3×3 stem conv, one
`deformableLKABlock` (16 channels; its two deform convs' gradients run
through the trainer) and a 1×1 head, the same on both sides. The JAX side
gets the variables after `initialize`, as its CLI's
`--pretrained_backbone` path does (values from `jax.eval_shape` and
seeded numpy, `test_torch_maxvit.jax_variables`: offsets past ±1, so the
JAX training dispatch takes the gather and its gradient is the port's).
Both trainers are fed the same batches.

- `Trainer2D`, 2 epochs × 2 batches of 2 images at 16², 4 classes,
  base LR 0.05: the step losses to rtol 1e-4, the LR of each update
  against the JAX trainer's own optax schedule at its update count to
  rtol 1e-6, each parameter tensor's update over the run within ‖Δ‖ ≤
  1e-3 · ‖update‖ plus the f32 rounding of the two p′ (2⁻²³ · ‖p′‖), the
  eval hook's epochs, and the checkpoints `epoch_2` and `best_model`.
- `TrainerSkin`, 2 epochs of 2 batches of 2 RGB images at 16², one
  class, base LR 1e-4, a plateau scheduler with patience 0 and threshold 1 (the scale
  halves after every epoch, so epoch 2 trains at half the LR): the step
  and validation losses to rtol 1e-4, the LR scales, the updates as
  above, the best validation loss and its checkpoint.
"""

from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deformablelka_tpu.data import skin as jskin
from deformablelka_tpu.nn import lka2d as jlka2d
from deformablelka_tpu.nn.layers import Conv2d as JConv2d
from deformablelka_tpu.training import trainer2d as jtd
from deformablelka_tpu_torch import trainer2d_path
from deformablelka_tpu_torch.convert.jax_params import state_dict_from_jax
from deformablelka_tpu_torch.data import skin as tskin
from deformablelka_tpu_torch.nn import lka2d as tlka2d
from deformablelka_tpu_torch.nn.layers import Conv2d
from deformablelka_tpu_torch.training import trainer2d as ttd
from deformablelka_tpu_torch.training.checkpoint import CheckpointManager

from test_torch_maxvit import jax_variables

torch.set_num_threads(1)
DIM, IMG, B = 16, 16, 2


class JTiny(fnn.Module):
    num_classes: int

    @fnn.compact
    def __call__(self, x):
        x = JConv2d(DIM, 3, name="stem")(x)
        x = jlka2d.deformableLKABlock(name="block")(x)
        return JConv2d(self.num_classes, 1, name="head")(x)


class TTiny(torch.nn.Module):
    def __init__(self, cin, num_classes):
        super().__init__()
        self.stem = Conv2d(cin, DIM, 3)
        self.block = tlka2d.deformableLKABlock(DIM)
        self.head = Conv2d(DIM, num_classes, 1)

    def forward(self, x):
        return self.head(self.block(self.stem(x)))


def carried(cin, num_classes, seed):
    """(JAX model, its variables, the port model with them)."""
    jm = JTiny(num_classes)
    v = jax_variables(jm, np.zeros((1, IMG, IMG, cin), np.float32), seed=seed)
    tm = TTiny(cin, num_classes)
    tm.load_state_dict(state_dict_from_jax(v, tm), strict=True)
    return jm, v, tm.eval()


def check_updates(jparams, tm, init):
    ref = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jparams)}, tm)
    after = tm.state_dict()
    assert sorted(ref) == sorted(after)
    for k in ref:
        want, got = ref[k] - init[k], after[k] - init[k]
        assert (got - want).norm() <= 1e-3 * want.norm() + 2 ** -23 * after[k].norm(), k


class Batches:
    """`.next()` over a fixed list of batches, in order."""

    def __init__(self, batches):
        self.batches, self.i = batches, 0
        self.num_batches = 2

    def next(self):
        self.i += 1
        return self.batches[self.i - 1]


def _batches(n, seed=0):
    out = []
    for i in range(n):
        b = trainer2d_path.synthetic_batch(seed + i, batch=B, img=IMG, num_classes=4)
        out.append(b)
    return out


@pytest.fixture(scope="module")
def synapse_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer2d")
    jm, v, tm = carried(1, 4, seed=3)
    init = {k: t.clone() for k, t in tm.state_dict().items()}
    batches = _batches(4)

    schedules = []
    sgd = optax.sgd

    def spy(learning_rate, **kw):
        schedules.append(learning_rate)
        return sgd(learning_rate, **kw)

    jhook, jlosses = [], []
    jt = jtd.Trainer2D(jm, tmp / "jax", Batches(batches), max_epochs=2,
                       iterations_per_epoch=2, eval_hook=lambda t: jhook.append(t.epoch),
                       eval_interval=1)
    with mock.patch.object(jtd.optax, "sgd", spy):
        jt.initialize(batches[0])
    jt.state = jt.state._replace(params=jax.tree_util.tree_map(jnp.asarray, v["params"]))
    step = jt._step_fn

    def recorded(state, batch):
        state, m = step(state, batch)
        jlosses.append(float(m["loss"]))
        return state, m

    jt._step_fn = recorded
    jt.run_training()

    tt = ttd.Trainer2D(tm, tmp / "port", Batches(batches), max_epochs=2,
                       iterations_per_epoch=2, eval_hook=lambda t: t.epoch, eval_interval=1)
    tt.initialize()
    tlosses, lrs = [], []
    train_step = tt.train_step

    def recorded_port(batch):
        loss = train_step(batch)
        tlosses.append(float(loss))
        lrs.append(tt.optimizer.param_groups[0]["lr"])
        return loss

    tt.train_step = recorded_port
    tt.run_training()
    return dict(jt=jt, jhook=jhook, jlosses=jlosses, schedule=schedules[0], tt=tt,
                tlosses=tlosses, lrs=lrs, init=init)


def test_trainer2d_losses_match_jax(synapse_runs):
    r = synapse_runs
    assert len(r["tlosses"]) == len(r["jlosses"]) == 4
    np.testing.assert_allclose(r["tlosses"], r["jlosses"], rtol=1e-4)
    np.testing.assert_allclose(r["tt"].losses, r["jt"].losses, rtol=1e-4)


def test_trainer2d_lr_is_the_optax_schedule_at_the_update_count(synapse_runs):
    r = synapse_runs
    np.testing.assert_allclose(r["lrs"], [float(r["schedule"](n)) for n in range(4)],
                               rtol=1e-6)
    assert r["tt"].step == 4
    assert int(optax.tree_utils.tree_get(r["jt"].state.opt_state, "count")) == 4


def test_trainer2d_updates_match_jax(synapse_runs):
    check_updates(synapse_runs["jt"].state.params, synapse_runs["tt"].model,
                  synapse_runs["init"])


def test_trainer2d_eval_hook_and_checkpoints(synapse_runs):
    r = synapse_runs
    assert r["jhook"] == [2] and r["tt"].eval_results == [(2, 2)]
    mgr = CheckpointManager(r["tt"].output_folder / "ckpt")
    state, meta = mgr.load("best_model")
    assert sorted(state) == ["model"] and meta == {"epoch": 2}
    for k, t in r["tt"].model.state_dict().items():
        torch.testing.assert_close(state["model"][k], t, rtol=0, atol=0)
    state, meta = mgr.load("epoch_2")
    assert sorted(state) == ["model", "optimizer", "step"] and state["step"] == 4


@pytest.fixture(scope="module")
def skin_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer_skin")
    root = trainer2d_path.write_skin(tmp / "data", (4, 2, 2), size=IMG)
    jm, v, tm = carried(3, 1, seed=4)
    init = {k: t.clone() for k, t in tm.state_dict().items()}
    base_lr = 1e-4  # the inputs are 0-255 (upstream's dataset_normalized)

    jt = jtd.TrainerSkin(jm, tmp / "jax", base_lr=base_lr, max_epochs=2, seed=0)
    jtrain = jskin.ISICLoader(root, "train", batch_size=B, seed=3)
    jt.initialize(next(jskin.ISICLoader(root, "train", batch_size=B).epoch()))
    jt.state = jt.state._replace(params=jax.tree_util.tree_map(jnp.asarray, v["params"]))
    jt.scheduler = jtd.ReduceLROnPlateau(patience=0, threshold=1.0)
    jrec = {"loss": [], "scale": [], "val": []}
    step, eval_loss = jt._step, jt._eval_loss

    def jstep(state, image, mask, lr_scale):
        state, loss = step(state, image, mask, lr_scale)
        jrec["loss"].append(float(loss))
        jrec["scale"].append(float(lr_scale))
        return state, loss

    def jeval(state, image, mask):
        loss = eval_loss(state, image, mask)
        jrec["val"].append(float(loss))
        return loss

    jt._step, jt._eval_loss = jstep, jeval
    jt.run_training(jtrain, jskin.ISICLoader(root, "val", batch_size=1), log_every=0)

    tt = ttd.TrainerSkin(tm, tmp / "port", base_lr=base_lr, max_epochs=2)
    tt.scheduler = ttd.ReduceLROnPlateau(patience=0, threshold=1.0)
    trec = {"loss": [], "lr": [], "val": []}
    tstep, teval = tt.train_step, tt.eval_loss

    def port_step(image, mask, lr_scale):
        loss = tstep(image, mask, lr_scale)
        trec["loss"].append(float(loss))
        trec["lr"].append(tt.optimizer.param_groups[0]["lr"])
        return loss

    def port_eval(image, mask):
        loss = teval(image, mask)
        trec["val"].append(float(loss))
        return loss

    tt.train_step, tt.eval_loss = port_step, port_eval
    tt.run_training(tskin.ISICLoader(root, "train", batch_size=B, seed=3),
                    tskin.ISICLoader(root, "val", batch_size=1), log_every=0)
    return dict(jt=jt, jrec=jrec, tt=tt, trec=trec, init=init, base_lr=base_lr)


def test_trainer_skin_losses_and_plateau_match_jax(skin_runs):
    j, t = skin_runs["jrec"], skin_runs["trec"]
    assert len(t["loss"]) == len(j["loss"]) == 4 and len(t["val"]) == len(j["val"]) == 4
    np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4)
    np.testing.assert_allclose(t["val"], j["val"], rtol=1e-4)
    assert j["scale"] == [1.0, 1.0, 0.5, 0.5]
    np.testing.assert_allclose(t["lr"], [skin_runs["base_lr"] * s for s in j["scale"]],
                               rtol=1e-6)
    assert skin_runs["tt"].scheduler.scale == skin_runs["jt"].scheduler.scale == 0.25


def test_trainer_skin_updates_match_jax(skin_runs):
    check_updates(skin_runs["jt"].state.params, skin_runs["tt"].model, skin_runs["init"])


def test_trainer_skin_best_checkpoint(skin_runs):
    tt, jt = skin_runs["tt"], skin_runs["jt"]
    np.testing.assert_allclose(tt.best_val_loss, jt.best_val_loss, rtol=1e-4)
    val = skin_runs["trec"]["val"]
    best_epoch = int(np.argmin([np.mean(val[:2]), np.mean(val[2:])])) + 1
    state, meta = CheckpointManager(tt.output_folder).load("best_model")
    assert sorted(state) == ["model"] and meta["epoch"] == best_epoch
    np.testing.assert_allclose(meta["val_loss"], tt.best_val_loss, rtol=1e-6)
    assert len(tt.epoch_times) == 2
