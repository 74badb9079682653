"""The last public functions of the JAX package that the port lacked,
against it on the CPU:

- the losses `soft_dice_squared`, `generalized_dice_loss` and
  `topk_cross_entropy` (`training/losses.py`) on seeded logits (2, 6, 8,
  8, 4) and labels, over their options: within 1e-6;
- `UnetBasicBlock` and `UnetUpBlock` (`nn/dynunet.py`), 3D and 2D, with
  instance norm and batch norm (running statistics), their weights
  carried from the JAX variables by `state_dict_from_jax` under MONAI's
  names: within 1e-5·max(1, max|JAX|) in float32; in bfloat16 the blocks
  follow the JAX blocks' types (tests/torch_bf16_parity.py), an
  `UnetUpBlock` with a bfloat16 skip promoting at the concatenation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deformablelka_tpu.nn import dynunet as jdyn
from deformablelka_tpu.training import losses as jl
from deformablelka_tpu_torch.nn import dynunet as tdyn
from deformablelka_tpu_torch.training import losses as tl

import torch_bf16_parity as P
from test_torch_maxvit import assert_close, carry, jax_variables

torch.set_num_threads(1)
LOGITS = np.random.RandomState(0).randn(2, 6, 8, 8, 4).astype(np.float32) * 2
LABELS = np.random.RandomState(1).randint(0, 4, (2, 6, 8, 8))


def both(jfn, tfn, **kw):
    ref = float(jfn(jnp.asarray(LOGITS), jnp.asarray(LABELS), **kw))
    got = float(tfn(torch.from_numpy(LOGITS), torch.from_numpy(LABELS), **kw))
    return got, ref


@pytest.mark.parametrize("do_bg", [False, True])
@pytest.mark.parametrize("batch_dice", [True, False])
def test_soft_dice_squared_matches_jax(do_bg, batch_dice):
    got, ref = both(jl.soft_dice_squared, tl.soft_dice_squared, do_bg=do_bg,
                    batch_dice=batch_dice)
    assert abs(got - ref) <= 1e-6, (got, ref)


@pytest.mark.parametrize("do_bg", [True, False])
@pytest.mark.parametrize("square_volumes", [True, False])
def test_generalized_dice_loss_matches_jax(do_bg, square_volumes):
    got, ref = both(jl.generalized_dice_loss, tl.generalized_dice_loss, do_bg=do_bg,
                    square_volumes=square_volumes)
    assert abs(got - ref) <= 1e-6, (got, ref)


@pytest.mark.parametrize("k_percent", [10.0, 50.0, 0.001])
def test_topk_cross_entropy_matches_jax(k_percent):
    got, ref = both(jl.topk_cross_entropy, tl.topk_cross_entropy, k_percent=k_percent)
    assert abs(got - ref) <= 1e-6, (got, ref)


def blocks(kind, dims, norm):
    if kind == "basic":
        return (jdyn.UnetBasicBlock(dims, 8, 3, 2, norm),
                tdyn.UnetBasicBlock(dims, 4, 8, 3, 2, norm))
    return (jdyn.UnetUpBlock(dims, 4, 3, 2, norm),
            tdyn.UnetUpBlock(dims, 8, 4, 3, 2, norm))


def inputs(kind, dims):
    rs = np.random.RandomState(2)
    S = (6, 8, 8)[3 - dims:]
    if kind == "basic":
        return (rs.randn(2, *S, 4).astype(np.float32),)
    return (rs.randn(2, *S, 8).astype(np.float32),
            rs.randn(2, *[2 * s for s in S], 4).astype(np.float32))


@pytest.mark.parametrize("kind", ["basic", "up"])
@pytest.mark.parametrize("dims", [3, 2])
@pytest.mark.parametrize("norm", ["instance", "batch"])
def test_block_matches_jax(kind, dims, norm):
    jm, tm = blocks(kind, dims, norm)
    xs = inputs(kind, dims)
    v = jax_variables(jm, *xs, seed=3)
    ref = np.asarray(jm.apply(v, *map(jnp.asarray, xs)))
    carry(v, tm)
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, xs)).numpy()
    assert_close(got, ref, 1e-5)


@pytest.mark.parametrize("kind", ["basic", "up"])
def test_block_in_bf16_follows_jax(kind):
    """The basic block on a bf16 input (bf16 out), and the up-block on an
    f32 input with a bf16 skip (the decoder's meeting point: f32 out),
    against JAX's eager forward (each op rounded where its code says):
    at most `BLOCK_FLIPS` of the elements off by more than f32 noise."""
    jm, tm = blocks(kind, 3, "instance")
    xs = list(inputs(kind, 3))
    v = jax_variables(jm, *xs, seed=3)
    carry(v, tm)
    xs[-1] = np.array(jnp.asarray(xs[-1], jnp.bfloat16).astype(jnp.float32))
    jin = [jnp.asarray(a) for a in xs[:-1]] + [jnp.asarray(xs[-1], jnp.bfloat16)]
    ref = np.asarray(jm.apply(v, *jin))
    tin = [torch.from_numpy(a) for a in xs[:-1]] + [torch.from_numpy(xs[-1]).bfloat16()]
    with torch.no_grad():
        got = tm(*tin)
    want = torch.bfloat16 if kind == "basic" else torch.float32
    assert got.dtype == want
    assert (ref.dtype == jnp.bfloat16) == (want is torch.bfloat16)
    ref = ref.astype(np.float32)
    d = np.abs(got.float().numpy() - ref)
    assert np.mean(d > 1e-3 * np.abs(ref) + 1e-6) <= P.BLOCK_FLIPS
