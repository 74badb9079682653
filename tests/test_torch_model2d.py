"""The port's 2D flagship, `MaxViTDeformableLKAFormer(num_classes=9)` at full
width and depth (MaxViT-small encoder, dims 96…768, depths 2/2/5/2, the
deformable-LKA decoder), against the JAX package's at img_size 64, batch 2,
on the CPU in float32; its deform sites; and the weight round trip through
the JAX package's own converter.

The JAX variables come from `jax_variables` (test_torch_maxvit.py): every
layer scale 1, the batch-norm statistics random, offset nets that push
offsets past ±1, so that BN, attention and the gates all shape the logits.
Tolerance: max|port − JAX| ≤ 1e-4·max(1, max|JAX|), and the argmax equal
everywhere.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deformablelka_tpu.convert.torch_loader import convert_maxvit_dlka
from deformablelka_tpu.models.maxvit_dlka import MaxViTDeformableLKAFormer as JModel
from deformablelka_tpu.nn import lka2d as jlka2d
from deformablelka_tpu_torch.main_path2d import LAUNCHES_PER_FORWARD
from deformablelka_tpu_torch.models.maxvit_dlka import MaxViTDeformableLKAFormer
from deformablelka_tpu_torch.nn.lka2d import DeformConv
from deformablelka_tpu_torch.ops import kernels

from test_torch_maxvit import assert_close, carry, jax_variables

torch.set_num_threads(1)
IMG = 64


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def count_calls(obj, name):
    """Patch obj.name with a wrapper that counts its calls."""
    fn = getattr(obj, name)
    calls = []
    return calls, mock.patch.object(obj, name, lambda *a, **k: calls.append(1) or fn(*a, **k))


def carried_model(deformable: bool):
    """(input, JAX variables, JAX logits, the carried port model)."""
    x = np.random.RandomState(0).randn(2, IMG, IMG, 1).astype(np.float32)
    jm = JModel(num_classes=9, img_size=IMG, deformable=deformable)
    v = jax_variables(jm, x, seed=1, layer_scale=1.0)
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    tm = carry(v, MaxViTDeformableLKAFormer(9, IMG, deformable))
    return x, jm, v, ref, tm


def check_against_jax(carried, config):
    """The port's logits against JAX's, and the kernel wrappers' calls
    per forward against `main_path2d.LAUNCHES_PER_FORWARD`."""
    x, _, _, ref, tm = carried
    deform_calls, p1 = count_calls(kernels, "deform_dw_conv2d")
    chain_calls, p2 = count_calls(kernels, "dw_chain2d")
    with p1, p2, torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert_close(got, ref, 1e-4)
    assert (got.argmax(-1) == ref.argmax(-1)).all()
    calls = {"deform_dw_conv2d": len(deform_calls), "dw_chain2d": len(chain_calls)}
    assert {n: c for n, c in calls.items() if c} == LAUNCHES_PER_FORWARD[config]


def check_round_trip(carried, deformable):
    """port state_dict → convert_maxvit_dlka → the JAX variables that went
    in, leaf for leaf."""
    _, _, v, _, tm = carried
    back = convert_maxvit_dlka({k: t.numpy() for k, t in tm.state_dict().items()},
                               deformable=deformable)
    want, got = flat(v), flat(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def flagship():
    return carried_model(deformable=True)


def test_flagship_matches_jax(flagship):
    offsets = []
    hooks = [m.offset_net.register_forward_hook(
        lambda _m, _i, out: offsets.append(out.abs().max().item()))
        for m in flagship[4].modules() if isinstance(m, DeformConv)]
    check_against_jax(flagship, "dlka")
    for h in hooks:
        h.remove()
    assert len(offsets) == 12 and min(offsets) > 1.0


def test_jax_flagship_has_twelve_deform_sites(flagship):
    """upstream's decoder_2/1/0 run two deformableLKABlocks each, with a
    5×5 and a 7×7-dil3 deform conv apiece; decoder_3 is a PatchExpand."""
    x, jm, v, _, _ = flagship
    calls, patch = count_calls(jlka2d, "deform_conv2d")
    with patch:
        jax.eval_shape(jm.apply, v, jnp.asarray(x))
    assert len(calls) == 12


def test_flagship_state_dict_round_trips_through_the_jax_converter(flagship):
    check_round_trip(flagship, deformable=True)
