"""The 2D zoo's MViT-LKA and DAT-LKA against the JAX package on the CPU:
the pooled window attention with padding, the decomposed relative
positions, the multi-scale block, the DAT local and shifted-window
attention, the deformable attention with its sampling and rpe bias, the
bilinear sampler (`ops.deform2d.grid_sample_bilinear`), and both models
whole at 224², batch 1, narrow widths, with the weight carry both ways
and the LKA decoder's chain launches.

Variables come from `jax.eval_shape` plus seeded numpy
(`test_torch_maxvit.jax_variables`). Tolerance, f32: max|port − JAX| ≤
1e-5·max(1, max|JAX|) for a module, 1e-4·max(1, max|JAX|) for a whole
model; the sampler 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deformablelka_tpu.convert import torch_loader as jconv
from deformablelka_tpu.models import dat_lka as jdat
from deformablelka_tpu.models import mvit as jmvit
from deformablelka_tpu.ops.deform2d import grid_sample_bilinear as jgrid_sample
from deformablelka_tpu_torch.models import dat_lka as tdat
from deformablelka_tpu_torch.models import mvit as tmvit
from deformablelka_tpu_torch.ops import kernels
from deformablelka_tpu_torch.ops.deform2d import grid_sample_bilinear
from test_torch_maxvit import assert_close
from test_torch_zoo_mit import model_case, randn, run_both

torch.set_num_threads(1)


def chain_calls(monkeypatch):
    """The shapes `kernels.dw_chain2d` is called at."""
    calls, real = [], kernels.dw_chain2d

    def spy(x, *args):
        calls.append(tuple(x.shape))
        return real(x, *args)

    monkeypatch.setattr(kernels, "dw_chain2d", spy)
    return calls


# ------------------------------------------------------------- MViT


def test_decomposed_rel_pos_matches_jax():
    rng = np.random.RandomState(0)
    for (qh, qw), (kh, kw) in (((8, 8), (4, 4)), ((4, 4), (8, 8)), ((6, 6), (6, 6))):
        dim = 2 * max(qh, kh) - 1
        attn = rng.randn(3, qh * qw, kh * kw).astype(np.float32)
        q = rng.randn(3, qh * qw, 5).astype(np.float32)
        rh, rw = (rng.randn(dim, 5).astype(np.float32) for _ in range(2))
        got = tmvit.add_decomposed_rel_pos(*map(torch.from_numpy, (attn, q, rh, rw)),
                                           (qh, qw), (kh, kw))
        ref = jmvit.add_decomposed_rel_pos(*map(jnp.asarray, (attn, q, rh, rw)),
                                           (qh, qw), (kh, kw))
        assert_close(got.numpy(), np.asarray(ref), 1e-6)
        np.testing.assert_array_equal(
            tmvit.rel_pos_index(qh, kh),
            np.asarray(jmvit._rel_pos_select(qh, kh, jnp.arange(dim))))


@pytest.mark.parametrize("window,stride_q,stride_kv,hw", [
    (8, 1, 2, 28),     # windows padded: 28 → 32 (q), 14 → 16 (k, v)
    (0, 2, 4, 28),     # global, q pooled
    (56, 1, 4, 56)])   # one window of the whole map (MViT's block 0)
def test_multiscale_attention_matches_jax(window, stride_q, stride_kv, hw):
    kw = dict(stride_q=stride_q, stride_kv=stride_kv, window_size=window,
              input_size=(hw, hw))
    run_both(jmvit.MultiScaleAttention(32, 2, **kw),
             tmvit.MultiScaleAttention(16, 32, 2, **kw), randn(1, hw, hw, 16, seed=1))


@pytest.mark.parametrize("dim,dim_out,stride_q", [(16, 16, 1), (16, 32, 2)])
def test_multiscale_block_matches_jax(dim, dim_out, stride_q):
    kw = dict(stride_q=stride_q, stride_kv=2, window_size=0, input_size=(28, 28))
    run_both(jmvit.MultiScaleBlock(dim, dim_out, 2, **kw),
             tmvit.MultiScaleBlock(dim, dim_out, 2, **kw), randn(1, 28, 28, dim, seed=2))


def test_mvit_lka_matches_jax_round_trips_and_runs_the_chain(monkeypatch):
    calls = chain_calls(monkeypatch)
    model_case(jmvit.MViTLKAFormer(num_classes=4, embed_dim=16),
               tmvit.MViTLKAFormer(4, embed_dim=16), jconv.convert_mvitlka)
    assert calls == [(1, 14, 14, 64)] * 2 + [(1, 28, 28, 32)] * 2 + [(1, 56, 56, 16)] * 2


# ------------------------------------------------------------- DAT


def test_grid_sample_bilinear_matches_jax():
    """align_corners, zero outside, corners that straddle the edge."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 9, 11, 4).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 5, 7, 2)).astype(np.float32)
    grid[0, 0, :3] = [[-1, -1], [1, 1], [0, 0]]          # corners and centre exactly
    got = grid_sample_bilinear(torch.from_numpy(x), torch.from_numpy(grid))
    ref = jgrid_sample(jnp.asarray(x), jnp.asarray(grid))
    assert_close(got.numpy(), np.asarray(ref), 1e-6)


@pytest.mark.parametrize("shift", [0, 4])
def test_dat_local_attention_matches_jax(shift):
    run_both(jdat.LocalAttentionDAT(24, 3, 7, shift), tdat.LocalAttentionDAT(24, 3, 7, shift),
             randn(2, 14, 14, 24, seed=4))


@pytest.mark.parametrize("stage,hw,use_pe", [(2, 14, True), (3, 7, True), (2, 14, False)])
def test_deformable_attention_matches_jax(stage, hw, use_pe):
    run_both(jdat.DAttention(48, 6, 3, stage, use_pe=use_pe),
             tdat.DAttention(48, 6, 3, stage, hw, use_pe=use_pe), randn(2, hw, hw, 48, seed=5))


def test_dat_stage_matches_jax():
    run_both(jdat.DATStage(24, 3, "LSLD", 3, 2, use_pe=True),
             tdat.DATStage(24, 3, "LSLD", 3, 2, 14, use_pe=True), randn(1, 14, 14, 24, seed=6))


def test_dat_lka_matches_jax_round_trips_and_runs_the_chain(monkeypatch):
    calls = chain_calls(monkeypatch)
    kw = dict(dims=(24, 48, 96, 192), depths=(2, 2, 2, 2))
    model_case(jdat.DATLKAFormer(num_classes=4, **kw), tdat.DATLKAFormer(4, **kw),
               jconv.convert_datlka)
    assert calls == [(1, 14, 14, 96)] * 2 + [(1, 28, 28, 48)] * 2 + [(1, 56, 56, 24)] * 2
