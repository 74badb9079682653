"""Every 3D transformer block of the registry (the 14 `--trans_block`
names and the ACDC variant) against the JAX package's, on the CPU in
float32, and the weight round trip through the JAX package's own
converter.

JAX variables take their shapes from `jax.eval_shape` of the block's init
and their values from seeded numpy (`jax_variables`), chosen so that every
parameter shows in the output (gamma, norm statistics and scales, biases,
attention temperatures, offset-conv weights large enough that offsets
pass ±1); they are carried into the port's block with
`load_state_dict(strict=True)` through `state_dict_from_jax`, and both
run on the same seeded input.
Each block runs at a stage shape with 32 channels (where the size-aware
gate takes the fused chain); the size-aware and ACDC blocks also run at
128 and 256 channels, where the size-aware gate's dilated conv is
`kernels.dwconv3d`. Tolerance: max|port − JAX| ≤ 1e-4·max(1, max|JAX|).
"""

from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deformablelka_tpu.convert.torch_loader import convert_dlka_former
from deformablelka_tpu.nn.transformer3d import TRANSFORMER_BLOCKS as JBLOCKS
from deformablelka_tpu_torch.convert.jax_params import state_dict_from_jax
from deformablelka_tpu_torch.nn.transformer3d import TRANSFORMER_BLOCKS as TBLOCKS

torch.set_num_threads(1)
NAMES = list(JBLOCKS)
DIM_AWARE = ["TransformerBlock_Deform_LKA_Channel_sequential",
             "TransformerBlock_Deform_LKA_Spatial_sequential",
             "TransformerBlock_3D_single_deform_LKA_acdc"]
# (name, S, C): every block at 4³×32; the dim-dependent gates at 4³×128
# and 2³×256 too
CASES = ([(n, 4, 32) for n in NAMES]
         + [(n, S, C) for n in DIM_AWARE for S, C in ((4, 128), (2, 256))])
PROJ = 16


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def jax_variables(module, x, seed=0, offset_scale=8.0, shapes=None):
    """Variables of the JAX `module` for input `x`: shapes from its init
    (or `shapes`, a tree of them from an earlier call's `jax.eval_shape`),
    values from numpy seeded with `seed`. Offset-conv weights are
    N(0, offset_scale² / fan_in) (3D) and N(0, 9 / fan_in) (2D)."""
    if shapes is None:
        shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, parent = path[-1], path[-2] if len(path) > 1 else ""
        shape = leaf.shape
        fan_in = np.prod(shape[:-1])
        if path[0] == "batch_stats":
            v = (rng.randn(*shape) * 0.1 if name == "mean"
                 else rng.uniform(0.5, 1.5, shape))
        elif name == "gamma" or name.startswith("temperature"):
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "pos_embed" or name == "bias":
            v = rng.randn(*shape) * 0.1
        elif name == "scale":
            v = 1 + rng.randn(*shape) * 0.1
        elif name == "deform_conv_weight":
            v = rng.uniform(-1, 1, shape) / shape[0]
        elif parent == "conv_offset":
            v = rng.randn(*shape) * offset_scale / np.sqrt(fan_in)
        elif parent == "offset_net":
            v = rng.randn(*shape) * 3.0 / np.sqrt(fan_in)
        else:
            v = rng.uniform(-1, 1, shape) / np.sqrt(fan_in)
        return v.astype(np.float32)

    def walk(tree, path):
        return {k: walk(v, path + (k,)) if isinstance(v, Mapping)
                else fill(path + (k,), v) for k, v in tree.items()}

    return walk(shapes, ())


def _carried(name, S, C, seed=0, apply=True):
    """JAX variables, the JAX output (if `apply`), the carried port block,
    the input."""
    x = np.random.RandomState(seed + 1).randn(2, S, S, S, C).astype(np.float32)
    jmod = JBLOCKS[name](input_size=S ** 3, hidden_size=C, proj_size=PROJ)
    v = jax_variables(jmod, x, seed)
    tmod = TBLOCKS[name](S ** 3, C, PROJ).eval()
    tmod.load_state_dict(state_dict_from_jax(v, tmod), strict=True)
    ref = np.asarray(jmod.apply(v, jnp.asarray(x))) if apply else None
    return v, ref, tmod, x


def test_registry_names_are_the_jax_packages():
    assert list(TBLOCKS) == NAMES and len(NAMES) == 15


@pytest.mark.parametrize("name,S,C", CASES, ids=[f"{n}-{S}^3xC{C}" for n, S, C in CASES])
def test_block_matches_jax(name, S, C):
    _, ref, tmod, x = _carried(name, S, C)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    err = np.abs(got - ref).max()
    assert err <= 1e-4 * max(1.0, np.abs(ref).max()), err
    assert np.abs(got - x).max() > 1e-2  # the block changed its input


@pytest.mark.parametrize("name", NAMES)
def test_state_dict_round_trips_through_the_jax_converter(name):
    """port state_dict → convert_dlka_former(only_block) → the JAX
    variables that went in, leaf for leaf."""
    v, _, tmod, _ = _carried(name, 2, 32, apply=False)
    sd = {f"blk.{k}": t.numpy() for k, t in tmod.state_dict().items()}
    back = convert_dlka_former(sd, only_block=("blk", "blk"))
    for collection in ("params", "batch_stats"):
        want = _flat(v.get(collection, {}))
        got = _flat(back[collection].get("blk", {}))
        assert sorted(got) == sorted(want), collection
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
