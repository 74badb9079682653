"""The port's modules one by one against the JAX package's, through the
weight carry (`deformablelka_tpu_torch.convert.jax_params`), on the CPU.

Each JAX module is initialised from a PRNG key; its variables are then
perturbed from seeded numpy (norm statistics, gamma, offset-conv weights
large enough that offsets pass ±1) so that every parameter shows in the
output, carried into the port module with `load_state_dict(strict=True)`,
and both run on the same seeded input in float32. Tolerance: atol 1e-4,
rtol 1e-4 (outputs are O(1); sums of up to a few thousand f32 terms, in
another order on each side).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deformablelka_tpu.models import dlka_former as jmodels
from deformablelka_tpu.nn import blocks3d as jblocks
from deformablelka_tpu.nn import dynunet as jdyn
from deformablelka_tpu.nn import layers as jlayers
from deformablelka_tpu.nn import norms as jnorms
from deformablelka_tpu.nn.transformer3d import TRANSFORMER_BLOCKS as JBLOCKS
from deformablelka_tpu_torch.convert.jax_params import state_dict_from_jax
from deformablelka_tpu_torch.models import dlka_former as tmodels
from deformablelka_tpu_torch.nn import blocks3d as tblocks
from deformablelka_tpu_torch.nn import dynunet as tdyn
from deformablelka_tpu_torch.nn import layers as tlayers
from deformablelka_tpu_torch.nn import norms as tnorms
from deformablelka_tpu_torch.nn.transformer3d import TransformerBlock_3D_single_deform_LKA

torch.set_num_threads(1)
BLOCK = "TransformerBlock_3D_single_deform_LKA"


def perturb(variables, seed=0, offset_scale=2.0):
    """Give default-initialised parameters values that show in the output;
    offset-conv weights are N(0, offset_scale² / fan_in)."""
    rng = np.random.RandomState(seed)

    def walk(tree, path):
        for k, v in list(tree.items()):
            if isinstance(v, dict):
                walk(v, path + (k,))
                continue
            v = np.asarray(v, np.float32)
            parent = path[-1] if path else ""
            if k == "gamma":
                v = rng.uniform(0.5, 1.5, v.shape)
            elif k == "pos_embed":
                v = rng.randn(*v.shape) * 0.1
            elif k == "mean":
                v = rng.randn(*v.shape) * 0.1
            elif k == "var":
                v = rng.uniform(0.5, 1.5, v.shape)
            elif k == "scale":
                v = 1 + rng.randn(*v.shape) * 0.1
            elif k == "bias" and not np.any(v):
                v = rng.randn(*v.shape) * 0.1
            elif k == "weight" and parent == "conv_offset":
                v = rng.randn(*v.shape) * offset_scale / np.sqrt(np.prod(v.shape[:-1]))
            tree[k] = np.asarray(v, np.float32)

    for collection in ("params", "batch_stats"):
        walk(variables.get(collection, {}), ())
    return variables


def carry(jmod, tmod, x, seed=0):
    """Init jmod, perturb, carry into tmod; return (port out, JAX out)."""
    v = jax.tree_util.tree_map(np.asarray, dict(jmod.init(
        jax.random.PRNGKey(seed), jnp.asarray(x))))
    v = perturb(v, seed)
    tmod.load_state_dict(state_dict_from_jax(v, tmod), strict=True)
    ref = jmod.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = tmod.eval()(torch.from_numpy(x))
    return got, ref


def assert_close(got, ref, atol=1e-4, rtol=1e-4):
    if isinstance(ref, (list, tuple)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert_close(g, r, atol, rtol)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol, rtol=rtol)


def rand(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("k,s,pad,dil,groups,bias", [
    (3, 1, "same", 1, 1, True), (1, 1, "same", 1, 1, True),
    ((2, 4, 4), (2, 4, 4), 0, 1, 1, False), (5, 1, 2, 1, 6, True),
    (7, 1, 9, 3, 6, True)])
def test_conv3d(k, s, pad, dil, groups, bias):
    x = rand(2, 8, 8, 8, 6)
    got, ref = carry(jlayers.Conv3d(4 if groups == 1 else 6, k, stride=s,
                                    padding=pad, dilation=dil, groups=groups,
                                    use_bias=bias),
                     tlayers.Conv3d(6, 4 if groups == 1 else 6, k, stride=s,
                                    padding=pad, dilation=dil, groups=groups,
                                    bias=bias), x)
    assert_close(got, ref)


@pytest.mark.parametrize("k", [2, (2, 4, 4)])
def test_conv_transpose(k):
    x = rand(1, 3, 2, 2, 5)
    got, ref = carry(jlayers.ConvTranspose(4, k, stride=k, use_bias=False),
                     tlayers.ConvTranspose(5, 4, k, stride=k, bias=False), x)
    assert_close(got, ref)


def test_linear_and_gelu():
    x = rand(2, 7, 5)
    got, ref = carry(jlayers.Linear(3), tlayers.Linear(5, 3), x)
    assert_close(got, ref)
    assert_close(tlayers.gelu(torch.from_numpy(x)), jlayers.gelu(jnp.asarray(x)),
                 atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", ["layer", "group", "instance", "instance_free",
                                  "batch"])
def test_norms(name):
    x = rand(2, 4, 5, 3, 8) * 2 + 0.5
    jmod, tmod = {
        "layer": (jnorms.LayerNorm(), tnorms.LayerNorm(8)),
        "group": (jnorms.GroupNorm(num_groups=4), tnorms.GroupNorm(4, 8)),
        "instance": (jnorms.InstanceNorm(), tnorms.InstanceNorm(8)),
        "instance_free": (jnorms.InstanceNorm(affine=False),
                          tnorms.InstanceNorm(8, affine=False)),
        "batch": (jnorms.BatchNorm(), tnorms.BatchNorm(8)),
    }[name]
    got, ref = carry(jmod, tmod, x)
    assert_close(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cin,cout,norm", [(4, 4, "batch"), (1, 6, "instance"),
                                           (6, 6, "instance")])
def test_unet_res_block(cin, cout, norm):
    x = rand(2, 6, 6, 6, cin)
    got, ref = carry(jdyn.UnetResBlock(3, cout, 3, 1, norm_name=norm),
                     tdyn.UnetResBlock(cin, cout, 3, 1, norm_name=norm), x)
    assert_close(got, ref)


def test_unet_out_block():
    x = rand(1, 4, 4, 4, 6)
    got, ref = carry(jdyn.UnetOutBlock(3, 14), tdyn.UnetOutBlock(6, 14), x)
    assert_close(got, ref)


@pytest.mark.parametrize("C", [4, 32])
def test_deform_conv_pack(C):
    x = rand(2, 4, 5, 6, C)
    got, ref = carry(jblocks.DeformConvPack3d(), tblocks.DeformConvPack3d(C), x)
    assert_close(got, ref)


def test_lka3d_deform_gate():
    x = rand(1, 6, 5, 7, 8)
    got, ref = carry(jblocks.LKA3dDeform(), tblocks.LKA3dDeform(8), x)
    assert_close(got, ref)


def test_gated_attention():
    x = rand(2, 5, 5, 5, 8)
    got, ref = carry(jblocks.GatedAttention3d(gate=jblocks.LKA3dDeform),
                     tblocks.GatedAttention3d(8), x)
    assert_close(got, ref)


@pytest.mark.parametrize("S,C", [(4, 32), (2, 64)])
def test_transformer_block(S, C):
    x = rand(2, S, S, S, C)
    got, ref = carry(JBLOCKS[BLOCK](input_size=S ** 3, hidden_size=C,
                                    proj_size=64),
                     TransformerBlock_3D_single_deform_LKA(S ** 3, C), x)
    assert_close(got, ref)


def test_encoder_full_widths():
    x = rand(1, 16, 32, 32, 1)
    sizes = [512, 64, 8, 1]
    got, ref = carry(
        jmodels.Encoder(dims=(32, 64, 128, 256), depths=(1, 1, 1, 1),
                        input_sizes=sizes, proj_sizes=(64, 64, 64, 32),
                        patch_size=(2, 4, 4), trans_block=BLOCK),
        tmodels.Encoder(1, (32, 64, 128, 256), (1, 1, 1, 1), sizes, (2, 4, 4)),
        x)
    # the JAX Encoder returns (x, hidden); the port returns hidden
    assert_close(got, ref[1])


@pytest.mark.parametrize("conv_decoder", [False, True])
def test_up_block(conv_decoder):
    rng = np.random.RandomState(2)
    x = rng.randn(1, 2, 2, 2, 16).astype(np.float32)
    ks = (2, 4, 4) if conv_decoder else 2
    skip_shape = (1, 4, 8, 8, 8) if conv_decoder else (1, 4, 4, 4, 8)
    skip = rng.randn(*skip_shape).astype(np.float32)
    jmod = jmodels.UpBlock(out_channels=8, upsample_kernel_size=ks, out_size=64,
                           depth=2, conv_decoder=conv_decoder, trans_block=BLOCK)
    tmod = tmodels.UpBlock(16, 8, ks, 64, depth=2, conv_decoder=conv_decoder)
    v = jax.tree_util.tree_map(np.asarray, dict(jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(skip))))
    v = perturb(v)
    tmod.load_state_dict(state_dict_from_jax(v, tmod), strict=True)
    ref = jmod.apply(v, jnp.asarray(x), jnp.asarray(skip))
    with torch.no_grad():
        got = tmod.eval()(torch.from_numpy(x), torch.from_numpy(skip))
    assert_close(got, ref)
