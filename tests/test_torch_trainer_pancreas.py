"""The port's Pancreas trainer against the JAX package's, on the CPU in
float32.

- `binary_dice_loss` and `pancreas_loss` (whole batch and `labeled_bs`)
  to 1e-6, and the step-decay LR (×0.1 at 2500 / 5000 / 7500 updates)
  against optax's `piecewise_constant_schedule` to rtol 1e-6;
- `TrainerPancreas` for 3 iterations on `dlka_net_pancreas(img_size=(32,
  32, 32))` with `trans_block="TransformerBlock_SE"` (the JAX step's
  compile with the D-LKA block takes minutes here), batch 2, labeled_bs
  1, both from the same variables (JAX's from `jax.eval_shape` and
  seeded numpy) and fed the same random crops (two loaders, one seed):
  the losses (total, CE, Dice) to rtol 1e-4 and each parameter tensor's
  update over the run within ‖Δ‖ ≤ 1e-3 · ‖update‖ plus the f32 rounding
  of the two p′ (2⁻²³ · ‖p′‖); the checkpoint holds the model's weights
  under "model".

The CLI (`train_pancreas` from an h5 fold, then `test_pancreas` on its
checkpoint) is held in tests/test_torch_run_training.py.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deformablelka_tpu.models.dlka_former import dlka_net_pancreas as jax_pancreas
from deformablelka_tpu.training import trainer_pancreas as jtp
from deformablelka_tpu_torch import trainer_path
from deformablelka_tpu_torch.convert.jax_params import state_dict_from_jax
from deformablelka_tpu_torch.models.dlka_former import dlka_net_pancreas
from deformablelka_tpu_torch.training import trainer_pancreas as ttp
from deformablelka_tpu_torch.training.checkpoint import CheckpointManager

from test_torch_block_variants import jax_variables

torch.set_num_threads(1)
PATCH = (32, 32, 32)
SHAPE = (40, 36, 24)
BLOCK = "TransformerBlock_SE"


def _logits_and_labels(seed, shape=(3, 6, 7, 5)):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape, 2).astype(np.float32) * 2,
            rng.randint(0, 2, shape).astype(np.int64))


@pytest.mark.parametrize("labeled_bs", [None, 1, 2])
def test_losses_match_jax(labeled_bs):
    logits, labels = _logits_and_labels(labeled_bs or 0)
    loss, (ce, dl) = ttp.pancreas_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                       labeled_bs)
    ref, (rce, rdl) = jtp.pancreas_loss(jnp.asarray(logits),
                                        jnp.asarray(labels.astype(np.int32)), labeled_bs)
    for got, want in ((loss, ref), (ce, rce), (dl, rdl)):
        np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=1e-6)
    probs = np.random.RandomState(5).rand(2, 4, 5, 3).astype(np.float32)
    target = labels[:2, :4, :5, :3] == 1
    np.testing.assert_allclose(
        ttp.binary_dice_loss(torch.from_numpy(probs), torch.from_numpy(target)).item(),
        float(jtp.binary_dice_loss(jnp.asarray(probs), jnp.asarray(target))),
        atol=1e-6, rtol=1e-6)


def test_step_decay_schedule_matches_optax():
    got = ttp.make_step_decay_schedule(0.01)
    ref = jtp.make_step_decay_schedule(0.01)
    counts = [0, 1, 2499, 2500, 2501, 4999, 5000, 7499, 7500, 10000, 60000]
    np.testing.assert_allclose([got(c) for c in counts], [float(ref(c)) for c in counts],
                               rtol=1e-6)
    assert [got(c) for c in (2499, 2500, 7500)] == pytest.approx([1e-2, 1e-3, 1e-5])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pancreas")
    jm = jax_pancreas(trans_block=BLOCK, img_size=PATCH)
    v = jax_variables(jm, np.zeros((2, *PATCH, 1), np.float32), seed=5)
    tm = dlka_net_pancreas(trans_block=BLOCK, img_size=PATCH, device="cpu")
    tm.load_state_dict(state_dict_from_jax(v, tm), strict=True)
    init = {k: t.clone() for k, t in tm.state_dict().items()}

    jt = jtp.TrainerPancreas(jm, tmp / "jax", max_iterations=3, batch_size=2,
                             labeled_bs=1)
    v_jnp = jax.tree_util.tree_map(jnp.asarray, v)
    with mock.patch.object(type(jm), "init", lambda self, rng, x: v_jnp):
        jt.initialize({"data": np.zeros((2, *PATCH, 1), np.float32)})
    jrec = []
    jt.run_training(trainer_path.pancreas_loader(0, SHAPE, PATCH), log_every=0,
                    callback=lambda it, s, m: jrec.append(
                        (int(optax.tree_utils.tree_get(s.opt_state, "count")),
                         *(float(m[k]) for k in ("loss", "loss_seg", "loss_seg_dice")))))

    tt = ttp.TrainerPancreas(tm, tmp / "port", max_iterations=3, batch_size=2,
                             labeled_bs=1)
    trec = []
    tt.run_training(trainer_path.pancreas_loader(0, SHAPE, PATCH), log_every=1,
                    callback=lambda it, model, m: trec.append(
                        (tt.step, *(float(m[k]) for k in ("loss", "loss_seg",
                                                          "loss_seg_dice")))))
    return dict(jt=jt, jrec=jrec, tt=tt, trec=trec, v=v, init=init)


def test_iterations_match_jax(runs):
    jrec, trec = runs["jrec"], runs["trec"]
    assert [r[0] for r in trec] == [r[0] for r in jrec] == [1, 2, 3]
    np.testing.assert_allclose([r[1:] for r in trec], [r[1:] for r in jrec], rtol=1e-4)


def test_updates_match_jax(runs):
    tm = runs["tt"].model
    ref = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray,
                                                                runs["jt"].state.params),
                               "batch_stats": runs["v"]["batch_stats"]}, tm)
    after = tm.state_dict()
    assert sorted(ref) == sorted(after)
    for k in ref:
        want, got = ref[k] - runs["init"][k], after[k] - runs["init"][k]
        assert (got - want).norm() <= 1e-3 * want.norm() + 2 ** -23 * after[k].norm(), k


def test_checkpoint_holds_the_model(runs):
    state, _ = CheckpointManager(runs["tt"].out_dir).load("d_lka_former_iter_3")
    assert sorted(state) == ["model", "step"] and state["step"] == 3
    for k, t in runs["tt"].model.state_dict().items():
        torch.testing.assert_close(state["model"][k], t, rtol=0, atol=0)
