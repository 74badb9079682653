"""The frozen plain reference against the program on the CPU at small
sizes (the program's CPU path computes its kernels' plain versions), and
the counts of one block against a hand count."""

import math

import pytest
import torch

from portbench import counts, harness
from portbench.reference import dlka_former_synapse as R3
from portbench.reference import maxvit_dlka_synapse2d as R2
from portbench.reference import sliding_window


def _cfg(img, do_ds):
    cfg = harness.load_json(harness.ROOT / "configs" / "dlka_former_synapse.json")
    return dict(cfg, img_size=img, do_ds=do_ds)


@pytest.mark.parametrize("img,do_ds", [([16, 32, 32], True), ([32, 64, 64], False)])
def test_reference_3d_matches_the_program(img, do_ds):
    from deformablelka_tpu_torch.models.dlka_former import dlka_former_synapse

    cfg = _cfg(img, do_ds)
    state = harness.make_state(R3.param_shapes(cfg), 4, "cpu")
    model = dlka_former_synapse(14, do_ds=do_ds, img_size=tuple(img), device="cpu")
    assert set(model.state_dict()) == set(state)
    model.load_state_dict(state)
    x = torch.randn(1, *img, 1, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        got = model(x)
        ref = R3.forward(state, cfg, x.movedim(-1, 1))
    got, ref = (got, ref) if do_ds else ([got], [ref])
    for g, r in zip(got, ref):
        r = r.movedim(1, -1)
        assert (g - r).abs().max() <= 1e-4 * r.abs().max()


def test_reference_training_loss_matches_the_program():
    from deformablelka_tpu_torch.models.dlka_former import dlka_former_synapse
    from deformablelka_tpu_torch.training.train_step import loss_of

    cfg = _cfg([16, 32, 32], True)
    state = harness.make_state(R3.param_shapes(cfg), 6, "cpu")
    model = dlka_former_synapse(14, do_ds=True, img_size=(16, 32, 32), device="cpu")
    model.load_state_dict(state)
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 16, 32, 32, 1, generator=g)
    y = torch.randint(0, 14, (2, 16, 32, 32), generator=g)
    assert float(loss_of(model, x, y)) == pytest.approx(float(R3.loss(state, cfg, x, y)), rel=1e-5)


def test_reference_2d_matches_the_program():
    from deformablelka_tpu_torch.models.maxvit_dlka import maxvit_dlka_former
    from deformablelka_tpu_torch.training.losses import dice_ce_2d_loss

    cfg = {"img_size": 64, "num_classes": 9}
    state = harness.make_state(R2.param_shapes(cfg), 8, "cpu")
    model = maxvit_dlka_former(9, img_size=64, device="cpu")
    assert set(model.state_dict()) == set(state)
    model.load_state_dict(state)
    g = torch.Generator().manual_seed(9)
    x = torch.randn(2, 64, 64, 1, generator=g)
    y = torch.randint(0, 9, (2, 64, 64), generator=g)
    with torch.no_grad():
        got, ref = model(x), R2.forward_cl(state, cfg, x)
        assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
        assert float(dice_ce_2d_loss(got, y)) == pytest.approx(float(R2.loss(state, cfg, x, y)),
                                                               rel=1e-5)


def test_reference_sliding_window_grid_and_map():
    from deformablelka_tpu_torch.inference.sliding_window import (compute_steps,
                                                                  gaussian_importance_map)

    patch, shape = (64, 128, 128), (96, 192, 160)
    steps = compute_steps(patch, shape, 0.5)
    assert sliding_window.origins(patch, shape, 0.5) == [
        (a, b, c) for a in steps[0] for b in steps[1] for c in steps[2]]
    small = (16, 32, 32)
    assert torch.equal(torch.from_numpy(sliding_window.gaussian(small)),
                       torch.from_numpy(gaussian_importance_map(small)))


def test_one_block_counted_by_hand():
    B, C, S = 2, 32, (4, 6, 8)
    V = math.prod(S)
    p = {k: torch.empty(s, device="meta")
         for k, (s, _) in R3._block_shapes("b", C, V).items()}
    x = torch.empty(B, C, *S, device="meta")
    c = counts.count_unit(lambda: R3.block(p, "b", x))
    one = 2 * B * V * C * C                       # a 1³ conv, multiply-adds × 2
    dense = 4 * one + 2 * B * V * 81 * 27 * C + 2 * 27 * one
    assert c["dense_flops"] == dense              # proj_1, conv1, proj_2, conv8; offsets; conv51
    t5 = math.prod(counts.taps_inside(s, 5, 1) for s in S)
    t7 = math.prod(counts.taps_inside(s, 7, 3) for s in S)
    assert c["kernels"]["dw_chain3d"]["flops"] == 2 * B * C * (t5 + t7)
    assert c["kernels"]["deform_conv3d"]["flops"] == B * V * 27 * (2 * C * C + 16 * C)
    assert c["flops"] == dense + 2 * B * C * (t5 + t7) + B * V * 27 * (2 * C * C + 16 * C)


def test_taps_inside_by_hand():
    # 7 taps of dilation 3 over 4 positions reach ±9: each position keeps
    # the centre tap and the ±3 taps that stay in [0, 4)
    assert counts.taps_inside(4, 7, 3) == sum(
        sum(0 <= z + 3 * t < 4 for t in range(-3, 4)) for z in range(4)) == 6
    assert counts.taps_inside(32, 5, 1) == 32 * 5 - 2 * (2 + 1)


def test_kernel_bound_never_beats_its_peaks():
    w = counts.kernel_work("deform_conv3d", {"x": (8, 32, 32, 32, 32), "co": 32})
    mix = 8 * 32 ** 3 * 27 * 2 * 32 * 32
    assert w["least_s"] == pytest.approx(3 * mix / counts.TF32_FLOP_PER_S)
    assert w["least_s"] >= w["bytes"] / counts.HBM_BYTES_PER_S


@pytest.mark.parametrize("groups", [1, 8])
def test_a_convolution_backward_costs_twice_its_forward(groups):
    x = torch.empty(2, 8, 10, 12, device="meta", requires_grad=True)
    w = torch.empty(16, 8 // groups, 3, 3, device="meta", requires_grad=True)
    fwd = 2 * 2 * 16 * (8 // groups) * 9 * 10 * 12
    c = counts.count_unit(lambda: torch.nn.functional.conv2d(x, w, padding=1, groups=groups)
                          .sum().backward())
    assert c["dense_flops"] == 3 * fwd
