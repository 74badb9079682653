"""The port's 2D modules one by one against the JAX package's, at narrow
widths, through the weight carry (`state_dict_from_jax`), on the CPU in
float32: the deformable-LKA and LKA blocks, MBConv, block- and
grid-partition attention, the MaxViT encoder (embed dims 32…256, depths
1/1/1/1), the decoder layers, the 2D conv helpers and the metrics.

JAX variables take their shapes from `jax.eval_shape` of the module's
init and their values from seeded numpy (`jax_variables`): norm
statistics and scales, biases and layer scales that show in the output,
offset-net weights large enough that offsets pass ±1. Tolerance:
max|port − JAX| ≤ 1e-5·max(1, max|JAX|) for single ops and blocks, and
1e-4·max(1, max|JAX|) for the encoder (f32 sums of up to a few thousand
terms in another order on each side, through a dozen layers).
"""

from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deformablelka_tpu.evaluation import metrics as jmetrics
from deformablelka_tpu.models import maxvit as jmaxvit
from deformablelka_tpu.models import maxvit_dlka as jdlka
from deformablelka_tpu.nn import lka2d as jlka2d
from deformablelka_tpu.ops.convs import conv2d as jconv2d
from deformablelka_tpu_torch.convert.jax_params import state_dict_from_jax
from deformablelka_tpu_torch.evaluation import metrics as tmetrics
from deformablelka_tpu_torch.main_path2d import OFFSET_SCALE
from deformablelka_tpu_torch.models import maxvit as tmaxvit
from deformablelka_tpu_torch.models import maxvit_dlka as tdlka
from deformablelka_tpu_torch.nn import lka2d as tlka2d
from deformablelka_tpu_torch.nn.lka2d import DeformConv
from deformablelka_tpu_torch.ops.convs import conv2d as tconv2d

torch.set_num_threads(1)
LAYER_SCALES = ("ls1", "ls2", "layer_scale_1", "layer_scale_2")


def jax_variables(module, *inputs, seed=0, layer_scale=None):
    """Variables of the JAX `module` for `inputs`: shapes from its init,
    values from numpy seeded with `seed`. Layer scales are `layer_scale`,
    or U(0.5, 1.5) per channel when it is None."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            *map(jnp.asarray, inputs))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, parent = path[-1], path[-2] if len(path) > 1 else ""
        shape = leaf.shape
        if path[0] == "batch_stats":
            v = (rng.randn(*shape) * 0.1 if name == "mean"
                 else rng.uniform(0.5, 1.5, shape))
        elif name in LAYER_SCALES:
            v = (rng.uniform(0.5, 1.5, shape) if layer_scale is None
                 else np.full(shape, layer_scale))
        elif name == "scale":
            v = 1 + rng.randn(*shape) * 0.1
        elif name == "bias":
            v = rng.randn(*shape) * 0.1
        elif name == "deform_conv_weight":
            v = rng.uniform(-1, 1, shape) / shape[0]
        elif parent == "offset_net":
            fan_in = np.prod(shape[:-1])
            v = rng.randn(*shape) * OFFSET_SCALE[shape[0]] / np.sqrt(fan_in)
        else:
            fan_in = np.prod(shape[:-1])
            v = rng.uniform(-1, 1, shape) / np.sqrt(fan_in)
        return v.astype(np.float32)

    def walk(tree, path):
        return {k: walk(v, path + (k,)) if isinstance(v, Mapping)
                else fill(path + (k,), v) for k, v in tree.items()}

    return walk(shapes, ())


def carry(variables, tmodule):
    tmodule.load_state_dict(state_dict_from_jax(variables, tmodule), strict=True)
    return tmodule.eval()


def assert_close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= rel * max(1.0, np.abs(ref).max()), err


def run_both(jmodule, tmodule, *inputs, rel=1e-5, seed=0, layer_scale=None,
             jit=False):
    v = jax_variables(jmodule, *inputs, seed=seed, layer_scale=layer_scale)
    apply = jax.jit(jmodule.apply) if jit else jmodule.apply
    ref = apply(v, *map(jnp.asarray, inputs))
    carry(v, tmodule)
    with torch.no_grad():
        got = tmodule(*map(torch.from_numpy, inputs))
    if isinstance(ref, (list, tuple)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert_close(g.numpy(), r, rel)
    else:
        assert_close(got.numpy(), ref, rel)
    return v, tmodule


def randn(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("block", ["deformableLKABlock", "LKABlock"])
def test_lka_blocks_match_jax(block):
    offsets = []
    tm = getattr(tlka2d, block)(16)
    hooks = [m.offset_net.register_forward_hook(
        lambda _m, _i, out: offsets.append(out.abs().max().item()))
        for m in tm.modules() if isinstance(m, DeformConv)]
    run_both(getattr(jlka2d, block)(), tm, randn(2, 12, 10, 16, seed=1))
    for h in hooks:
        h.remove()
    if block == "deformableLKABlock":
        assert len(offsets) == 2 and max(offsets) > 1.0


@pytest.mark.parametrize("stride,cin,cout", [(1, 32, 32), (2, 32, 48)])
def test_mbconv_matches_jax(stride, cin, cout):
    run_both(jmaxvit.MbConv(cout, stride=stride),
             tmaxvit.MbConv(cin, cout, stride=stride),
             randn(2, 8, 8, cin, seed=2))


@pytest.mark.parametrize("partition", ["block", "grid"])
def test_partition_attention_matches_jax(partition):
    run_both(jmaxvit.PartitionAttentionCl(partition_type=partition, window_size=4),
             tmaxvit.PartitionAttentionCl(64, partition, window_size=4),
             randn(2, 8, 8, 64, seed=3))


def test_relative_position_tables_match_jax():
    for ws in (2, 4, 7):
        np.testing.assert_array_equal(tmaxvit._rel_index(ws), jmaxvit._rel_index(ws))
        np.testing.assert_array_equal(tmaxvit._rel_log_coords(ws),
                                      jmaxvit._rel_log_coords(ws))


def test_maxvit_encoder_matches_jax_at_narrow_width():
    dims, depths = (32, 64, 128, 256), (1, 1, 1, 1)
    run_both(jmaxvit.MaxViT4Out(embed_dims=dims, depths=depths, img_size=64),
             tmaxvit.MaxViT4Out(dims, depths, img_size=64),
             randn(2, 64, 64, 3, seed=4), rel=1e-4, jit=True)


@pytest.mark.parametrize("deformable", [True, False], ids=["deform", "lka"])
def test_last_decoder_layer_matches_jax(deformable):
    x1, x2 = randn(1, 8, 8, 16, seed=5), randn(1, 8, 8, 16, seed=6)
    run_both(jdlka.DecoderLayer(out_dim=16, n_class=5, is_last=True,
                                deformable=deformable),
             tdlka.DecoderLayer(16, n_class=5, is_last=True, deformable=deformable),
             x1, x2)


def test_patch_expand_matches_jax():
    run_both(jdlka.PatchExpand(), tdlka.PatchExpand(32), randn(2, 4, 6, 32, seed=7))


@pytest.mark.parametrize("kw", [dict(stride=2, padding=1), dict(padding="same"),
                                dict(padding=9, dilation=3, groups=8)],
                         ids=["stride2", "same", "dilated-depthwise"])
def test_conv2d_matches_jax(kw):
    k = 3 if "groups" not in kw else 7
    cin_g = 8 // kw.get("groups", 1)
    x, w, b = randn(2, 10, 12, 8, seed=8), randn(k, k, cin_g, 8, seed=9), randn(8, seed=10)
    ref = jconv2d(jnp.asarray(x), jnp.asarray(w), bias=jnp.asarray(b), **kw)
    got = tconv2d(torch.from_numpy(x), torch.from_numpy(w).permute(3, 2, 0, 1),
                  torch.from_numpy(b), **kw)
    assert_close(got.numpy(), ref, 1e-5)


def test_metrics_match_jax():
    rng = np.random.RandomState(11)
    pred = rng.rand(6, 30, 28) > 0.6
    gt = rng.rand(6, 30, 28) > 0.5
    assert tmetrics.dice(pred, gt) == jmetrics.dice(pred, gt)
    assert tmetrics.hd95(pred, gt, (2.0, 1.0, 1.0)) == jmetrics.hd95(pred, gt, (2.0, 1.0, 1.0))
    assert np.isnan(tmetrics.hd95(pred, np.zeros_like(gt)))
