"""The port's data-parallel training step (`make_train_step(..., mesh=)`) on
2 gloo ranks on the CPU.

The Synapse loss takes its Dice over the batch's summed tp, fp and fn
(`batch_dice=True`), so the mean of the ranks' own losses is not the
global batch's loss. The labels here leave class 3 out of the first half
of the batch, so the difference is large, and the tests show it:

- a small conv net (3³ conv, ReLU, 1³ conv; one deep-supervision head)
  under `dc_and_ce_loss`, global batch 4 of 8³: the step's loss and each
  tensor's update p' − p against JAX's `make_train_step` with
  `shard_batch` on a 2-device mesh (loss rtol 1e-6, update ‖Δ‖ ≤ 1e-3 ·
  ‖update‖ per tensor), and against the port's single-process step on
  the global batch; the mean of the ranks' own losses is not the loss;
- `dlka_net_pancreas` at 32³ (deep supervision, gates driven so the
  offsets pass ±1), global batch 2: against the port's own single-process
  step on the global batch (tests/test_torch_train_step.py holds that
  step against JAX's), at the same tolerances;
- the parameters after each step are bitwise equal on the two ranks.

The rank function is at module level and JAX is imported inside the tests
only, so that a spawned rank imports neither.
"""

import numpy as np
import pytest
import torch

from deformablelka_tpu_torch.main_path import drive_gates
from deformablelka_tpu_torch.models.dlka_former import dlka_net_pancreas
from deformablelka_tpu_torch.ops.convs import conv3d
from deformablelka_tpu_torch.parallel import make_mesh, replicated, shard_batch
from deformablelka_tpu_torch.parallel.launch import run_ranks
from deformablelka_tpu_torch.training.losses import dc_and_ce_loss, poly_lr
from deformablelka_tpu_torch.training.train_step import make_sgd, make_train_step

torch.set_num_threads(1)
LR = poly_lr(0, 1000, 1e-2)
PANCREAS_IMG = (32, 32, 32)


def _small_batch():
    rng = np.random.RandomState(0)
    image = rng.randn(4, 8, 8, 8, 1).astype(np.float32)
    label = np.concatenate([rng.randint(0, 3, (2, 8, 8, 8)),      # no class 3
                            rng.randint(0, 4, (2, 8, 8, 8))]).astype(np.int64)
    return image, label


def _small_params():
    """JAX layout: w1 (3, 3, 3, 1, 8), w2 (1, 1, 1, 8, 4)."""
    rng = np.random.RandomState(1)
    return {"w1": (rng.randn(3, 3, 3, 1, 8) * 0.3).astype(np.float32),
            "b1": (rng.randn(8) * 0.1).astype(np.float32),
            "w2": (rng.randn(1, 1, 1, 8, 4) * 0.3).astype(np.float32),
            "b2": (rng.randn(4) * 0.1).astype(np.float32)}


class SmallNet(torch.nn.Module):
    def __init__(self, p):
        super().__init__()
        t = lambda a: torch.nn.Parameter(torch.from_numpy(a.copy()))
        self.w1 = t(p["w1"].transpose(4, 3, 0, 1, 2))
        self.b1, self.b2 = t(p["b1"]), t(p["b2"])
        self.w2 = t(p["w2"].transpose(4, 3, 0, 1, 2))

    def forward(self, x):
        return [conv3d(torch.relu(conv3d(x, self.w1, self.b1)), self.w2, self.b2)]


def _pancreas_model():
    model = dlka_net_pancreas(2, do_ds=True, img_size=PANCREAS_IMG, seed=0, device="cpu")
    drive_gates(model, 11)
    return model


def _pancreas_batch():
    rng = np.random.RandomState(2)
    return (torch.from_numpy(rng.randn(2, *PANCREAS_IMG, 1).astype(np.float32)),
            torch.from_numpy(rng.randint(0, 2, (2, *PANCREAS_IMG)).astype(np.int64)))


def _step(model, image, label, mesh=None):
    """One step; the loss, the grad norm and the parameters after it."""
    step = make_train_step(model, make_sgd(model.parameters(), LR), mesh=mesh)
    m = step(image, label)
    return float(m["loss"]), float(m["grad_norm"]), {
        k: v.detach().clone() for k, v in model.state_dict().items()}


def _ranks(rank, world):
    mesh = make_mesh(("data",), device_type="cpu")
    image, label = (torch.from_numpy(a) for a in _small_batch())
    local = shard_batch(mesh, {"image": image, "label": label})
    net = SmallNet(_small_params())
    with torch.no_grad():
        own_loss = float(dc_and_ce_loss(net(local["image"])[0], local["label"]))
    out = {"own_loss": own_loss, "small": _step(net, local["image"], local["label"], mesh)}
    model = _pancreas_model()
    replicated(model)
    image, label = shard_batch(mesh, _pancreas_batch())
    out["pancreas"] = _step(model, image, label, mesh)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(_ranks, 2, tmp_path_factory.mktemp("dp"))


def _check_updates(after, ref_after, before):
    assert sorted(after) == sorted(ref_after)
    for k in ref_after:
        want, got = ref_after[k] - before[k], after[k] - before[k]
        assert (got - want).norm() <= 1e-3 * want.norm() + 2 ** -23 * after[k].norm(), k


def _jax_small_step():
    """JAX's `make_train_step` on the 2-device mesh, the batch sharded."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from deformablelka_tpu.parallel.mesh import make_mesh as jmake_mesh
    from deformablelka_tpu.parallel.mesh import replicated as jreplicated
    from deformablelka_tpu.parallel.mesh import shard_batch as jshard_batch
    from deformablelka_tpu.training.train_step import (init_train_state, make_sgd as jsgd,
                                                       make_train_step as jstep)

    def conv(x, w, b):
        return lax.conv_general_dilated(x, w, (1, 1, 1), "SAME",
                                        dimension_numbers=("NDHWC", "DHWIO", "NDHWC")) + b

    def apply_fn(variables, x):
        p = variables["params"]
        return [conv(jax.nn.relu(conv(x, p["w1"], p["b1"])), p["w2"], p["b2"])]

    mesh = jmake_mesh(("data",), devices=jax.devices()[:2])
    tx = jsgd(LR)
    params = {k: jnp.asarray(v) for k, v in _small_params().items()}
    state = jax.device_put(init_train_state({"params": params}, tx), jreplicated(mesh))
    image, label = _small_batch()
    batch = jshard_batch(mesh, {"image": jnp.asarray(image),
                                "label": jnp.asarray(label.astype(np.int32))})
    state, metrics = jax.jit(jstep(apply_fn, tx))(state, batch)
    after = {k: torch.from_numpy(np.array(v)) for k, v in state.params.items()}
    for k in ("w1", "w2"):
        after[k] = after[k].permute(4, 3, 0, 1, 2)
    return float(metrics["loss"]), float(metrics["grad_norm"]), after


def test_small_net_step_is_the_global_batch_step_of_jax(ranks):
    before = SmallNet(_small_params()).state_dict()
    j_loss, j_norm, j_after = _jax_small_step()
    image, label = (torch.from_numpy(a) for a in _small_batch())
    s_loss, _, s_after = _step(SmallNet(_small_params()), image, label)
    for r in ranks:
        loss, norm, after = r["small"]
        np.testing.assert_allclose(loss, j_loss, rtol=1e-6)
        np.testing.assert_allclose(norm, j_norm, rtol=1e-5)
        np.testing.assert_allclose(loss, s_loss, rtol=1e-6)
        _check_updates(after, j_after, before)
        _check_updates(after, s_after, before)


def test_mean_of_rank_losses_is_not_the_global_loss(ranks):
    mean_own = np.mean([r["own_loss"] for r in ranks])
    loss = ranks[0]["small"][0]
    assert abs(mean_own - loss) > 1e-2 * abs(loss), (mean_own, loss)


@pytest.mark.parametrize("name", ["small", "pancreas"])
def test_parameters_are_equal_on_the_ranks(ranks, name):
    a, b = ranks[0][name][2], ranks[1][name][2]
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert ranks[0][name][:2] == ranks[1][name][:2]


def test_pancreas_step_is_the_single_process_step(ranks):
    before = {k: v.clone() for k, v in _pancreas_model().state_dict().items()}
    s_loss, s_norm, s_after = _step(_pancreas_model(), *_pancreas_batch())
    loss, norm, after = ranks[0]["pancreas"]
    np.testing.assert_allclose(loss, s_loss, rtol=1e-6)
    np.testing.assert_allclose(norm, s_norm, rtol=1e-5)
    _check_updates(after, s_after, before)
