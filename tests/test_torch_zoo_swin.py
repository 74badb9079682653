"""The 2D zoo's Swin family against the JAX package on the CPU: Swin-UNet,
STViT-LKA, SemanticSTViT and HiFormer (at both `reference_exact`
values), their new modules one by one and each model whole at 224²
(the zoo's fixed geometry), batch 1, narrow widths; the STViT pad mask
where a map is padded to its windows; the weight carry both ways; every
zoo model's full-width variables into the registry's model.

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
from deformablelka_tpu.models import hiformer as jhi
from deformablelka_tpu.models import registry as jreg
from deformablelka_tpu.models import stvit as jst
from deformablelka_tpu.models import swinunet as jsw
from deformablelka_tpu_torch.convert.jax_params import state_dict_from_jax
from deformablelka_tpu_torch.models import hiformer as thi
from deformablelka_tpu_torch.models import registry as treg
from deformablelka_tpu_torch.models import stvit as tst
from deformablelka_tpu_torch.models import swinunet as tsw
from test_torch_maxvit import assert_close, carry, jax_variables
from test_torch_zoo_mit import assert_round_trip, model_case, randn, run_both

torch.set_num_threads(1)

SHIFT = 3


# ------------------------------------------------------------- modules


@pytest.mark.parametrize("shift,clamp", [(0, True), (SHIFT, True), (SHIFT, False)])
def test_swin_block_matches_jax(shift, clamp):
    """At 14² a shifted block rolls and masks; at 7² with `clamp_shift` it
    does not shift, without it it rolls within the lone window."""
    for hw in (14, 7):
        run_both(jsw.SwinBlock(32, 2, 7, shift, clamp_shift=clamp),
                 tsw.SwinBlock(32, 2, 7, shift, clamp_shift=clamp),
                 randn(2, hw * hw, 32, seed=hw), static=(hw, hw))


def test_swin_shift_mask_matches_jax():
    for H, ws, s in ((14, 7, 3), (56, 7, 3), (28, 7, 4), (7, 7, 3)):
        np.testing.assert_array_equal(tsw.shift_mask_np(H, H, ws, s),
                                      np.asarray(jsw.shift_mask(H, H, ws, s)))
    np.testing.assert_array_equal(tsw.relative_position_index(7),
                                  jsw.relative_position_index(7))


def test_patch_merging_matches_jax():
    run_both(jsw.PatchMerging(24), tsw.PatchMerging(24), randn(2, 14 * 14, 24, seed=3),
             static=(14, 14))


def test_unfold_and_adaptive_pool_match_jax():
    x = randn(2, 14, 14, 5, seed=4)
    for k, stride, lo, hi in ((14, 7, 3, 4), (21, 7, 7, 7), (27, 3, 12, 12)):
        np.testing.assert_array_equal(
            tst.extract_patches(torch.from_numpy(x), k, stride, lo, hi).numpy(),
            np.asarray(jst.extract_patches(jnp.asarray(x), k, stride, lo, hi)))
    w = randn(8, 7, 7, 5, seed=5)
    np.testing.assert_array_equal(tst.adaptive_max_pool(torch.from_numpy(w), 3).numpy(),
                                  np.asarray(jst.adaptive_max_pool(jnp.asarray(w), 3)))


@pytest.mark.parametrize("hw", [14, 12])
def test_semantic_and_restore_blocks_match_jax(hw):
    """At 12² the map is padded to the 7-windows (14²), so the −1000 pad
    mask is live."""
    if hw == 12:
        mask = tst.pad_mask_np(14, 14, 2, 2, 14, 7, 3, 4, 9)
        np.testing.assert_array_equal(
            mask, np.asarray(jst._pad_mask(14, 14, 2, 2, 14, 7, 3, 4, 9)))
        assert (mask == -1000).any() and (mask == 0).any()
    x = randn(1, hw * hw, 32, seed=6)
    v = run_both(jst.SemanticAttentionBlock(32, 2, k_window_size=14),
                 tst.SemanticAttentionBlock(32, 2, k_window_size=14), x, static=(hw, hw))
    s, _, _ = jst.SemanticAttentionBlock(32, 2, k_window_size=14).apply(v, jnp.asarray(x),
                                                                        hw, hw)
    run_both(jst.RestoreBlock(32, 2), tst.RestoreBlock(32, 2), x, np.array(s),
             static=(hw, hw))


def test_deit_stage_matches_jax():
    run_both(jst.DeitStage(32, 2), tst.DeitStage(32, 2), randn(1, 14 * 14, 32, seed=7),
             static=(14, 14))


@pytest.mark.parametrize("exact", [False, True], ids=["published", "reference_exact"])
def test_hiformer_fusion_block_matches_jax(exact):
    xs = [randn(1, 1 + 16, 32, seed=8), randn(1, 1 + 4, 64, seed=9)]
    kw = dict(dims=(32, 64), num_heads=(2, 2), reference_exact=exact)
    jm, tm = jhi.MultiScaleBlock(**kw), thi.MultiScaleBlock(**kw)
    v = jax_variables(_ListIn(jm), *xs)
    ref = jm.apply(v, [jnp.asarray(x) for x in xs])
    carry(v, tm)
    with torch.no_grad():
        got = tm([torch.from_numpy(x) for x in xs])
    for g, r in zip(got, ref):
        assert_close(g.numpy(), np.asarray(r), 1e-5)
    assert ("fusion0_0" in v["params"]) == (not exact)
    assert tm.blocks is None if exact else len(tm.blocks[0]) == 1


class _ListIn:
    """`jax_variables` of a JAX module that takes a list."""

    def __init__(self, m):
        self.m = m

    def init(self, key, *xs):
        return self.m.init(key, list(xs))


# ------------------------------------------------------------- models


def test_swinunet_matches_jax_and_round_trips():
    kw = dict(embed_dim=16, num_heads=(1, 2, 4, 8))
    model_case(jsw.SwinUNet(num_classes=4, **kw), tsw.SwinUNet(4, **kw),
               jconv.convert_swinunet)


def test_stvit_lka_matches_jax_and_round_trips():
    kw = dict(embed_dim=24, num_heads=(1, 2, 4, 8))
    model_case(jst.STVitLKA(num_classes=4, **kw), tst.STVitLKA(4, **kw),
               jconv.convert_stvitlka)


def test_semantic_stvit_matches_jax_and_round_trips():
    kw = dict(embed_dim=24, depths=(2, 2, 6, 2, 2, 2, 2), num_heads=(1, 2, 4, 8, 4, 2, 1))
    model_case(jst.SemanticSTViT(num_classes=4, **kw), tst.SemanticSTViT(4, **kw),
               jconv.convert_semantic_stvit)


@pytest.mark.parametrize("exact", [False, True], ids=["published", "reference_exact"])
def test_hiformer_matches_jax_and_round_trips(exact):
    """The JAX converter skips the fusion and branch blocks (dead in the
    reference file): with `reference_exact` the round trip is whole, else
    whole but for those."""
    kw = dict(swin_dims=(32, 64, 128), cnn_dims=(16, 32, 64), cnn_blocks=(1, 1, 1),
              swin_depths=(2, 2, 2), swin_heads=(1, 2, 4), dlf_heads=(2, 2),
              reference_exact=exact)
    jm, tm = jhi.HiFormer(num_classes=4, **kw), thi.HiFormer(4, **kw)
    x = randn(1, 224, 224, 3, seed=10)
    v = jax_variables(jm, x)
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    carry(v, tm)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert_close(got, ref, 1e-4)
    dead = lambda p: p[0] == "params" and p[1].startswith("dlf") and (
        p[2].startswith("fusion") or p[2].startswith("block"))
    assert any(dead(p) for p in _paths(v)) == (not exact)
    assert_round_trip(jconv.convert_hiformer, v, tm, drop=dead)


def _paths(tree, prefix=()):
    for k, t in tree.items():
        if isinstance(t, dict):
            yield from _paths(t, prefix + (k,))
        else:
            yield prefix + (k,)


# ------------------------------------------- full width, every zoo model


ZOO = [n for n in treg.MODELS_2D if not n.startswith("maxvit")]
CONVERTERS = {"daeformer": jconv.convert_daeformer, "dae_lka": jconv.convert_daelka,
              "mvit_lka": jconv.convert_mvitlka, "dat_lka": jconv.convert_datlka,
              "stvit_lka": jconv.convert_stvitlka,
              "semantic_stvit": jconv.convert_semantic_stvit,
              "bidaeformer": jconv.convert_bidae, "swinunet": jconv.convert_swinunet,
              "segformer": jconv.convert_segformer, "transunet": jconv.convert_transunet,
              "hiformer": jconv.convert_hiformer}


def test_the_registry_has_the_jax_names():
    assert list(treg.MODELS_2D) == list(jreg.MODELS_2D)
    assert sorted(CONVERTERS) == sorted(ZOO) and len(ZOO) == 11
    with pytest.raises(ValueError, match="unknown 2D model 'unet'"):
        treg.build_model_2d("unet", device="cpu")


@pytest.mark.parametrize("name", ZOO)
def test_full_width_variables_carry_into_the_registry_model(name):
    """The JAX registry's model at upstream widths, 224², 9 classes: its
    variables (each leaf a constant of its own) load strictly into the
    port's registry model, and the JAX converter of the port's
    state_dict gives them back (less HiFormer's fusion and branch blocks,
    which it skips)."""
    shapes = jax.eval_shape(jreg.build_model_2d(name, 9, 224).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 1)))
    count = iter(range(1, 1 << 30))

    def fill(tree):
        return {k: fill(t) if isinstance(t, Mapping) else
                np.broadcast_to(np.float32(next(count) / 1024), t.shape)
                for k, t in tree.items()}

    variables = fill(shapes)
    model = treg.build_model_2d(name, 9, 224, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, model), strict=True)
    assert model.training is False
    dead = (lambda p: p[1].startswith("dlf") and p[2][:5] in ("fusio", "block")) \
        if name == "hiformer" else (lambda p: False)
    assert_round_trip(CONVERTERS[name], variables, model, drop=dead)
