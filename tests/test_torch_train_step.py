"""The port's training step against the JAX package's, on the CPU in float32.

- the losses (`dc_and_ce_loss`, `deep_supervision_loss` with 3 heads,
  `downsample_labels`, `poly_lr`) on seeded logits and labels;
- the optimizer against `make_sgd` (clip 12 → weight decay → Nesterov
  0.99) for 3 steps on a small parameter set, one of them clipped;
- one step of the whole model against `make_train_step`, in a narrow
  configuration (depths (1, 1, 1, 1), dims (8, 16, 32, 64), feature size
  4: the full widths make the JAX step's compile take minutes) at
  img_size (16, 32, 32), batch 2, deep supervision, JAX remat off, from
  carried weights perturbed so that the offsets pass ±1;
- the port's step with remat on and off gives the same gradients;
- the training path (`train_path.py`) builds and steps on the CPU.

Tolerances: losses atol/rtol 1e-6 (one reduction, in another order);
optimizer 1e-6; the model step's loss rtol 1e-5 and grad norm rtol 1e-4
(logits agree to ~1e-5, see tests/test_torch_model.py), and each
parameter tensor's update p' − p within ‖Δ‖ ≤ 1e-3 · ‖update‖: an offset
sampled next to a floor may land on the other side of it in the other
framework, which changes a few gradient entries locally, so updates are
compared per tensor by norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deformablelka_tpu.models.dlka_former import DLKAFormer as JaxDLKAFormer
from deformablelka_tpu.training import losses as jlosses
from deformablelka_tpu.training.train_step import (
    init_train_state, make_sgd as jax_make_sgd, make_train_step as jax_make_train_step)
from deformablelka_tpu_torch import train_path
from deformablelka_tpu_torch.convert.jax_params import state_dict_from_jax
from deformablelka_tpu_torch.models.dlka_former import DLKAFormer
from deformablelka_tpu_torch.nn.blocks3d import DeformConvPack3d
from deformablelka_tpu_torch.training import losses
from deformablelka_tpu_torch.training.train_step import (
    clip_grad_norm, loss_of, make_sgd, make_train_step)

from test_torch_modules import perturb

torch.set_num_threads(1)
IMG = (16, 32, 32)
NARROW = dict(patch_size=(2, 4, 4), depths=(1, 1, 1, 1), dims=(8, 16, 32, 64),
              feature_size=4, do_ds=True)
LR = losses.poly_lr(0, 1000, 1e-2)


def _logits_and_labels(seed, shape=(2, 4, 6, 8), C=5):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape, C).astype(np.float32) * 2,
            rng.randint(0, C, shape).astype(np.int64))


@pytest.mark.parametrize("name", ["dice", "ce", "dc_and_ce", "dc_and_ce_masked"])
def test_losses_match_jax(name):
    logits, labels = _logits_and_labels(0)
    mask = (np.random.RandomState(1).rand(*labels.shape) > 0.3).astype(np.float32)
    fn = {"dice": (losses.SoftDiceLoss(), jlosses.SoftDiceLoss()),
          "ce": (losses.cross_entropy, jlosses.cross_entropy),
          "dc_and_ce": (losses.dc_and_ce_loss, jlosses.dc_and_ce_loss),
          "dc_and_ce_masked": (losses.dc_and_ce_loss, jlosses.dc_and_ce_loss)}[name]
    masked = name == "dc_and_ce_masked"
    got = fn[0](torch.from_numpy(logits), torch.from_numpy(labels),
                loss_mask=torch.from_numpy(mask) if masked else None)
    ref = fn[1](jnp.asarray(logits), jnp.asarray(labels.astype(np.int32)),
                loss_mask=jnp.asarray(mask) if masked else None)
    np.testing.assert_allclose(got.item(), float(ref), atol=1e-6, rtol=1e-6)


def test_deep_supervision_loss_and_schedule_match_jax():
    labels = np.random.RandomState(2).randint(0, 4, (2, 8, 16, 16))
    outs = [_logits_and_labels(s, (2, 8 // f, 16 // f, 16 // f), 4)[0]
            for s, f in ((3, 1), (4, 2), (5, 4))]
    got = losses.deep_supervision_loss([torch.from_numpy(o) for o in outs],
                                       torch.from_numpy(labels))
    ref = jlosses.deep_supervision_loss([jnp.asarray(o) for o in outs],
                                        jnp.asarray(labels.astype(np.int32)))
    np.testing.assert_allclose(got.item(), float(ref), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(
        losses.downsample_labels(torch.from_numpy(labels), (2, 4, 4)).numpy(),
        np.asarray(jlosses.downsample_labels(jnp.asarray(labels), (2, 4, 4))))
    np.testing.assert_allclose(losses.deep_supervision_weights(3),
                               jlosses.deep_supervision_weights(3))
    for epoch in (0, 1, 500, 999):
        assert losses.poly_lr(epoch, 1000, 1e-2) == pytest.approx(
            jlosses.poly_lr(epoch, 1000, 1e-2), rel=1e-12)


def test_sgd_matches_optax_for_three_steps_one_clipped():
    rng = np.random.RandomState(3)
    init = {"a": rng.randn(3, 4).astype(np.float32),
            "b": rng.randn(5).astype(np.float32)}
    # gradient norms about 3, 40 (clipped to 12) and 1
    grads = [{k: (rng.randn(*v.shape) * s).astype(np.float32) for k, v in init.items()}
             for s in (0.8, 10.0, 0.25)]
    tx = jax_make_sgd(lambda s: LR)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = make_sgd(tp.values(), LR)
    clipped = 0
    for g in grads:
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        updates, state = tx.update(jg, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm = clip_grad_norm(tp.values())
        opt.step()
        clipped += float(norm) > 12
        np.testing.assert_allclose(float(norm), float(optax.global_norm(jg)), rtol=1e-6)
        for k in init:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       atol=1e-6, rtol=1e-6)
    assert clipped == 1


@pytest.fixture(scope="module")
def jax_step():
    """Carried weights, the batch, and the JAX step's loss, grad norm and
    updated parameters (as a port state_dict)."""
    rng = np.random.RandomState(0)
    image = rng.randn(2, *IMG, 1).astype(np.float32)
    label = np.random.RandomState(1).randint(0, 14, (2, *IMG)).astype(np.int64)
    jm = JaxDLKAFormer(out_channels=14, img_size=IMG, **NARROW)
    v = jax.tree_util.tree_map(np.asarray, dict(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(image))))
    v = perturb(v, seed=6, offset_scale=20.0)
    tx = jax_make_sgd(lambda s: LR)
    state = init_train_state(jax.tree_util.tree_map(jnp.asarray, v), tx)
    step = jax.jit(jax_make_train_step(jm.apply, tx, deep_supervision=True))
    new_state, metrics = step(state, {"image": jnp.asarray(image),
                                      "label": jnp.asarray(label.astype(np.int32))})
    new_v = {"params": jax.tree_util.tree_map(np.asarray, new_state.params),
             "batch_stats": v["batch_stats"]}
    return (image, label, v, float(metrics["loss"]), float(metrics["grad_norm"]),
            new_v)


def _port_model(v, remat=False):
    tm = DLKAFormer(14, img_size=IMG, remat=remat, **NARROW)
    tm.load_state_dict(state_dict_from_jax(v, tm), strict=True)
    return tm.eval()


def test_train_step_matches_jax(jax_step):
    image, label, v, loss_ref, norm_ref, new_v = jax_step
    tm = _port_model(v)
    before = {k: t.clone() for k, t in tm.state_dict().items()}
    offsets = []
    hooks = [m.conv_offset.register_forward_hook(
        lambda _m, _i, out: offsets.append(out.abs().max().item()))
        for m in tm.modules() if isinstance(m, DeformConvPack3d)]
    step = make_train_step(tm, make_sgd(tm.parameters(), LR))
    m = step(torch.from_numpy(image), torch.from_numpy(label))
    for h in hooks:
        h.remove()
    assert len(offsets) == 13 and max(offsets) > 1.0
    np.testing.assert_allclose(m["loss"].item(), loss_ref, rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(), norm_ref, rtol=1e-4)
    ref = state_dict_from_jax(new_v, tm)
    after = tm.state_dict()
    assert sorted(ref) == sorted(after)
    moved = 0
    for k in ref:
        want, got = ref[k] - before[k], after[k] - before[k]
        assert (got - want).norm() <= 1e-3 * want.norm(), k
        moved += bool(want.norm() > 0)
    assert moved == len(dict(tm.named_parameters()))


def test_remat_gives_the_same_gradients(jax_step):
    image, label, v = jax_step[:3]
    grads = []
    for remat in (False, True):
        tm = _port_model(v, remat)
        loss_of(tm, torch.from_numpy(image), torch.from_numpy(label)).backward()
        grads.append({n: p.grad for n, p in tm.named_parameters()})
    for n, g in grads[0].items():
        torch.testing.assert_close(grads[1][n], g, atol=0, rtol=0)


def test_train_path_builds_and_steps_on_the_cpu():
    """The training path at a small size: the seeded batch, the driven gates
    (gamma 1, offset-conv weights drawn), and one step that moves every
    parameter."""
    path = train_path.build(img_size=IMG, device="cpu")
    assert path.image.shape == (2, *IMG, 1) and path.image.dtype == torch.float32
    assert path.label.dtype == torch.int64
    assert 0 <= int(path.label.min()) and int(path.label.max()) < 14
    packs = [m for m in path.model.modules() if isinstance(m, DeformConvPack3d)]
    assert len(packs) == 21 and all(m.conv_offset.weight.any() for m in packs)
    before = {n: p.detach().clone() for n, p in path.model.named_parameters()}
    m = train_path.step(path)
    assert torch.isfinite(m["loss"]) and 0 < float(m["grad_norm"]) < float("inf")
    for n, p in path.model.named_parameters():
        assert not torch.equal(p.detach(), before[n]), n
