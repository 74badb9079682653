"""The 2D slice as a whole: one training step of the flagship at full width
(`MaxViTDeformableLKAFormer(num_classes=9)`, MaxViT-small encoder, 12
deform convs) at 64², batch 2, through the port's `Trainer2D` against
`jax.grad` of the JAX `Trainer2D`'s loss (`dice_ce_2d_loss` of the model
under `deform_impl(train_impl())`), on the CPU in float32, from the same
variables (`test_torch_maxvit.jax_variables`: layer scales 1, batch-norm
statistics random, offset nets that push offsets past ±1, so the JAX
training dispatch takes the gather; the offsets are not integers, where
the window and the gather VJPs would differ).

Tolerances: the loss to rtol 1e-5; each parameter tensor's gradient
within ‖Δg‖ ≤ 1e-4 · ‖g‖ + 1e-9 · ‖G‖ (G the whole gradient) and the
whole within 1e-4 · ‖G‖ (f32 sums in another order through ~40 layers
and their backward: the worst tensor reads 1.1e-5 here). The absolute
term is for the relative-position MLPs' output biases, whose gradient is
zero in exact arithmetic (a per-head constant added to a softmax's
logits): in f32 both sides read ~1e-11, rounding. The update of the step
(SGD momentum 0.9, wd 1e-4, the poly LR at count 0) as the gradient's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deformablelka_tpu.models.maxvit_dlka import MaxViTDeformableLKAFormer as JModel
from deformablelka_tpu.ops import deform_impl, train_impl
from deformablelka_tpu.training.losses import dice_ce_2d_loss
from deformablelka_tpu_torch import trainer2d_path
from deformablelka_tpu_torch.convert.jax_params import state_dict_from_jax
from deformablelka_tpu_torch.models.maxvit_dlka import MaxViTDeformableLKAFormer
from deformablelka_tpu_torch.nn.lka2d import DeformConv
from deformablelka_tpu_torch.training.trainer2d import Trainer2D

from test_torch_maxvit import carry, jax_variables

torch.set_num_threads(1)
IMG, B = 64, 2


@pytest.fixture(scope="module")
def step(tmp_path_factory):
    batch = trainer2d_path.synthetic_batch(3, batch=B, img=IMG)
    jm = JModel(num_classes=9, img_size=IMG, deformable=True)
    v = jax_variables(jm, batch["image"], seed=2, layer_scale=1.0)

    def loss_of(params):
        with deform_impl(train_impl()):
            out = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                           jnp.asarray(batch["image"]))
        return dice_ce_2d_loss(out, jnp.asarray(batch["label"]))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_of))(
        jax.tree_util.tree_map(jnp.asarray, v["params"]))

    tm = carry(v, MaxViTDeformableLKAFormer(9, IMG, deformable=True))
    offsets = []
    hooks = [m.offset_net.register_forward_hook(
        lambda _m, _i, out: offsets.append(out.detach()))
        for m in tm.modules() if isinstance(m, DeformConv)]
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    trainer = Trainer2D(tm, tmp_path_factory.mktemp("step2d"), None, max_epochs=2,
                        iterations_per_epoch=2)
    trainer.initialize()
    loss = float(trainer.train_step(batch))
    for h in hooks:
        h.remove()
    ref = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jgrads)}, tm)
    grads = {n: p.grad for n, p in tm.named_parameters()}
    upd = {n: p.detach() - before[n] for n, p in tm.named_parameters()}
    return dict(loss=loss, jloss=float(jloss), ref=ref, grads=grads, upd=upd,
                before=before, lr=trainer.lr(0), offsets=offsets)


def test_offsets_pass_one_and_are_not_integers(step):
    offs = step["offsets"]
    assert len(offs) == 12
    assert min(o.abs().max().item() for o in offs) > 1.0
    assert all(bool((o != o.round()).all()) for o in offs)


def test_loss_matches_jax(step):
    np.testing.assert_allclose(step["loss"], step["jloss"], rtol=1e-5)


def test_gradients_match_jax_tensor_by_tensor(step):
    ref, grads = step["ref"], step["grads"]
    assert sorted(ref) == sorted(grads)
    flat = lambda d: torch.cat([d[n].flatten() for n in sorted(d)])
    whole = flat(ref).norm()
    for n in ref:
        assert (grads[n] - ref[n]).norm() <= 1e-4 * ref[n].norm() + 1e-9 * whole, n
        if n.endswith("rel_pos.mlp.fc2.bias"):
            assert max(ref[n].norm(), grads[n].norm()) <= 1e-9 * whole, n
    assert (flat(grads) - flat(ref)).norm() <= 1e-4 * whole
    offset_grads = [n for n in ref if n.endswith("offset_net.weight")]
    assert len(offset_grads) == 12 and all(grads[n].abs().max() > 0 for n in offset_grads)


def test_update_is_sgd_of_the_jax_gradient(step):
    """Step 1: momentum starts empty, so p' − p = −lr · (g + 1e-4 · p)."""
    for n, g in step["ref"].items():
        want = -step["lr"] * (g + 1e-4 * step["before"][n])
        got = step["upd"][n]
        assert (got - want).norm() <= 1e-4 * want.norm() + 2 ** -23 * step["before"][n].norm(), n
