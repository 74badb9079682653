"""The 2D zoo's MiT family against the JAX package on the CPU: SegFormer,
DAEFormer, DAE-LKA and BiDAEFormer, their new modules one by one and each
model whole, at 224² (the zoo's fixed geometry), batch 1, narrow widths
and one block per stage; the BiFormer routing's chosen windows; the LKA
decoder layer's input width; the weight carry both ways (the port's
`state_dict_from_jax`, then the JAX package's own converter of upstream
state_dicts on the port's `state_dict()`, which must give back exactly the
variables it was filled from).

Variables come from `jax.eval_shape` plus seeded numpy
(`test_torch_maxvit.jax_variables`). Tolerance, f32: max|port − JAX| ≤
1e-5·max(1, max|JAX|) for a module, 1e-4·max(1, max|JAX|) for a whole
model.
"""

from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deformablelka_tpu.convert import torch_loader as jconv
from deformablelka_tpu.models import biformer as jbi
from deformablelka_tpu.models import dae_lka as jdaelka
from deformablelka_tpu.models import daeformer as jdae
from deformablelka_tpu.models import maxvit_dlka as jdlka
from deformablelka_tpu.nn import segformer as jseg
from deformablelka_tpu_torch.models import biformer as tbi
from deformablelka_tpu_torch.models import dae_lka as tdaelka
from deformablelka_tpu_torch.models import daeformer as tdae
from deformablelka_tpu_torch.models import maxvit_dlka as tdlka
from deformablelka_tpu_torch.nn import segformer as tseg
from deformablelka_tpu_torch.ops import kernels
from test_torch_maxvit import assert_close, carry, jax_variables

torch.set_num_threads(1)
IMG = 224
MODULE_TOL, MODEL_TOL = 1e-5, 1e-4


def randn(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def image(channels=1, seed=0):
    return randn(1, IMG, IMG, channels, seed=seed)


def run_both(jmodule, tmodule, *inputs, rel=MODULE_TOL, seed=0, static=()):
    """Both modules on the same seeded variables and inputs; `static` are
    trailing non-array arguments (H, W). Returns the JAX variables."""
    v = jax_variables(jmodule, *inputs, *static, seed=seed) if not static else \
        _variables_static(jmodule, inputs, static, seed)
    ref = jmodule.apply(v, *map(jnp.asarray, inputs), *static)
    carry(v, tmodule)
    with torch.no_grad():
        got = tmodule(*map(torch.from_numpy, inputs), *static)
    for g, r in zip(_leaves(got), _leaves(ref)):
        assert_close(g.numpy(), np.asarray(r), rel)
    return v


def _variables_static(jmodule, inputs, static, seed):
    wrapped = _Static(jmodule, static)
    v = jax_variables(wrapped, *inputs, seed=seed)
    return {c: t["inner"] for c, t in v.items()}


class _Static:
    """`jax_variables` of a module with static trailing arguments."""

    def __init__(self, module, static):
        self.module, self.static = module, static

    def init(self, key, *inputs):
        return {c: {"inner": t} for c, t in
                self.module.init(key, *inputs, *self.static).items()}


def _leaves(out):
    """The arrays of an output (nested lists and tuples; sizes left out)."""
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _leaves(o)]
    return [out] if hasattr(out, "shape") else []


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def assert_round_trip(convert, variables, tmodel, drop=lambda path: False):
    """The JAX converter of upstream state_dicts, run on the port's
    state_dict, gives back exactly `variables` (less the paths `drop`
    names, which the converter documents as skipped)."""
    sd = {k: v.detach().numpy() for k, v in tmodel.state_dict().items()}
    back = flat({c: t for c, t in convert(sd).items() if t})
    want = {p: a for p, a in flat(variables).items() if not drop(p)}
    assert sorted(back) == sorted(want)
    for p in want:
        assert back[p].shape == want[p].shape, p
        assert np.array_equal(back[p], want[p]), p


def model_case(jmodel, tmodel, convert, seed=0, channels=1):
    x = image(channels, seed)
    v = jax_variables(jmodel, x, seed=seed)
    ref = np.asarray(jax.jit(jmodel.apply)(v, jnp.asarray(x)))
    carry(v, tmodel)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    assert_close(got, ref, MODEL_TOL)
    assert_round_trip(convert, v, tmodel)
    return got


# ------------------------------------------------------------- modules


@pytest.mark.parametrize("ratio", [1, 4])
def test_efficient_self_attention_matches_jax(ratio):
    run_both(jseg.EfficientSelfAtten(32, 2, ratio), tseg.EfficientSelfAtten(32, 2, ratio),
             randn(2, 28 * 28, 32, seed=1), static=(28, 28))


@pytest.mark.parametrize("token_mlp", ["mix", "mix_skip", "mlp"])
def test_segformer_block_matches_jax(token_mlp):
    run_both(jseg.SegFormerBlock(40, 5, 2, token_mlp), tseg.SegFormerBlock(40, 5, 2, token_mlp),
             randn(1, 28 * 28, 40, seed=2), static=(28, 28))


def test_bridge_attention_matches_jax():
    """M_EfficientSelfAtten over the 4-scale token stack (ScaleReduce)."""
    dim, sp, folds = 8, (16, 8, 4, 2), (1, 2, 5, 8)
    n = sum(s * s * f for s, f in zip(sp, folds))
    run_both(jseg.MEfficientSelfAtten(dim, 2, spatial=sp, folds=folds),
             tseg.MEfficientSelfAtten(dim, 2, spatial=sp, folds=folds),
             randn(1, n, dim, seed=3))
    run_both(jseg.SelfAtten(dim, 2), tseg.SelfAtten(dim, 2), randn(2, 50, dim, seed=4))


def test_efficient_and_channel_attention_match_jax():
    run_both(jdae.EfficientAttention(32, 32, 32, 2), tdae.EfficientAttention(32, 32, 32, 2),
             randn(2, 14, 12, 32, seed=5))
    run_both(jdae.ChannelAttention(32), tdae.ChannelAttention(32), randn(2, 70, 32, seed=6))


def test_dual_and_cross_attention_blocks_match_jax():
    run_both(jdae.DualTransformerBlock(32, 32, 32), tdae.DualTransformerBlock(32, 32, 32),
             randn(1, 28 * 28, 32, seed=7), static=(28, 28))
    run_both(jdae.CrossAttentionBlock(32, 32, 32), tdae.CrossAttentionBlock(32, 32, 32),
             randn(1, 14 * 14, 32, seed=8), randn(1, 14 * 14, 32, seed=9), static=(14, 14))


@pytest.mark.parametrize("dims", [(16, 8), (8, 16)])
def test_lka_decoder_layer_takes_its_input_width_from_x1(dims):
    """The JAX `x1_linear` takes its input width from x1: DAE-LKA's
    decoder_1 maps 256 channels to 320 (here 16 → 8 and 8 → 16)."""
    x1_dim, dim = dims
    run_both(jdlka.DecoderLayer(out_dim=dim, deformable=False),
             tdlka.DecoderLayer(dim, deformable=False, in_dim=x1_dim),
             randn(1, 14, 14, x1_dim, seed=10), randn(1, 14, 14, dim, seed=11))


def test_flagship_state_dict_keys_are_unchanged_by_the_input_width():
    for deformable in (True, False):
        default = tdlka.DecoderLayer(96, deformable=deformable)
        explicit = tdlka.DecoderLayer(96, deformable=deformable, in_dim=96)
        assert {k: v.shape for k, v in default.state_dict().items()} == \
            {k: v.shape for k, v in explicit.state_dict().items()}
    model = tdlka.MaxViTDeformableLKAFormer(deformable=False)
    assert model.decoder_1.x1_linear.weight.shape == (192, 192)
    assert model.decoder_0.x1_linear.weight.shape == (96, 96)


def test_routing_takes_lax_top_k_windows_ties_to_the_lower_index():
    rng = np.random.RandomState(12)
    q = rng.randn(2, 64, 16).astype(np.float32)
    k = rng.randn(2, 64, 16).astype(np.float32)
    k[:, 40:] = k[:, 40:41]        # 24 equal windows: ties in every row
    for topk in (1, 4, 16, 30):
        got = tbi.routing_indices(torch.from_numpy(q), torch.from_numpy(k), topk, 0.25)
        logits = jnp.einsum("npc,nqc->npq", jnp.asarray(q) * 0.25, jnp.asarray(k))
        _, want = jax.lax.top_k(logits, topk)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("hw,topk", [(28, 16), (56, 1)])
def test_bilevel_routing_attention_matches_jax(hw, topk):
    """Routing at 28² pads the map to the 8-window grid (32²)."""
    jm = jbi.BiLevelRoutingAttention(32, 2, n_win=8, topk=topk)
    tm = tbi.BiLevelRoutingAttention(32, 2, n_win=8, topk=topk)
    x = randn(1, hw, hw, 32, seed=13)
    run_both(jm, tm, x)
    # the windows the port routes to are the JAX module's
    v = jax_variables(jm, x)
    xw = torch.from_numpy(x)
    pad = (-hw) % 8
    xw = torch.nn.functional.pad(xw, (0, 0, 0, pad, 0, pad))
    H = hw + pad
    h = H // 8
    win = xw.reshape(1, 8, h, 8, h, 32).permute(0, 1, 3, 2, 4, 5).reshape(1, 64, h, h, 32)
    with torch.no_grad():
        qkv = tm.qkv(win)
    q_win, k_win = qkv[..., :32].mean((2, 3)), qkv[..., 32:64].mean((2, 3))
    got = tbi.routing_indices(q_win, k_win, topk, 32 ** -0.5)
    w = v["params"]["qkv"]
    jq = jnp.asarray(win.numpy()) @ w["weight"] + w["bias"]
    logits = jnp.einsum("npc,nqc->npq", jq[..., :32].mean((2, 3)) * 32 ** -0.5,
                        jq[..., 32:64].mean((2, 3)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.lax.top_k(logits, topk)[1]))


def test_attention_lepe_and_biformer_block_match_jax():
    run_both(jbi.AttentionLePE(64, 8), tbi.AttentionLePE(64, 8), randn(1, 14, 14, 64, seed=14))
    run_both(jbi.BiFormerBlock(64, 2, topk=4), tbi.BiFormerBlock(64, 2, topk=4),
             randn(1, 16, 16, 64, seed=15))


# ------------------------------------------------------------- models


def test_segformer_matches_jax_and_round_trips():
    kw = dict(dims=(16, 32, 40, 64), layers=(1, 1, 1, 1), embed_dim=32)
    model_case(jseg.SegFormer(num_classes=4, **kw), tseg.SegFormer(4, **kw),
               jconv.convert_segformer)


def test_daeformer_matches_jax_and_round_trips():
    kw = dict(dims=(32, 64, 128), layers=(1, 1, 1))
    model_case(jdae.DAEFormer(num_classes=4, **kw), tdae.DAEFormer(4, **kw),
               jconv.convert_daeformer)


def test_dae_lka_matches_jax_round_trips_and_runs_the_chain():
    kw = dict(dims=(32, 64, 128), layers=(1, 1, 1))
    tm = tdaelka.DAELKAFormer(4, **kw)
    calls = []
    real = kernels.dw_chain2d

    def spy(x, *args):
        calls.append(tuple(x.shape))
        return real(x, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kernels, "dw_chain2d", spy)
        model_case(jdaelka.DAELKAFormer(num_classes=4, **kw), tm, jconv.convert_daelka)
    # layer_lka_1 twice in decoder_1 (28²) and decoder_0 (56²)
    assert calls == [(1, 28, 28, 64)] * 2 + [(1, 56, 56, 32)] * 2


def test_bidaeformer_matches_jax_and_round_trips():
    kw = dict(dims=(64, 96, 128), depths=(1, 1, 1))
    model_case(jbi.BiDAEFormer(num_classes=4, **kw), tbi.BiDAEFormer(4, **kw),
               jconv.convert_bidae, channels=3)
