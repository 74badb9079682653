"""The hand weight gradient of the dense stride-1 3D convs (kernel 7,
`ops.kernels.conv3d_wgrad`) and the autograd Function that takes it in
`ops.convs.conv3d`.

On the CPU the Function's backward takes the plain version
(`convs.conv3d_weight_grad`, one GEMM a tap): its dx, dW and bias
gradient are held against autograd of `F.conv3d` on the same tensors (dx
and the bias gradient are the same `convolution_backward` call, so
equal; dW sums in another order, 1e-5 of its largest). The dispatch rule
is held on its inputs, the launch plans at every shape of the two
training cells, and the per-step counts against the models. The last
test, marked `cuda`, holds the kernel against the plain version on the
card and two calls bitwise equal: `python -m pytest
tests/test_torch_conv3d_wgrad.py -m cuda --noconftest`.
"""

from unittest import mock

import pytest
import torch
import torch.nn.functional as F

from deformablelka_tpu_torch import train_path, trainer_path
from deformablelka_tpu_torch.models.dlka_former import dlka_former_synapse, dlka_net_pancreas
from deformablelka_tpu_torch.models.swin_unetr import swin_unetr_btcv
from deformablelka_tpu_torch.nn.dynunet import UnetResBlock
from deformablelka_tpu_torch.nn.layers import init_parameters
from deformablelka_tpu_torch.ops import convs, kernels
from deformablelka_tpu_torch.ops.convs import conv3d_weight_grad, to_ncdhw, to_ndhwc

CHANNELS = [(1, 16), (16, 16), (16, 14), (32, 81), (48, 48)]


def _inputs(B, S, ci, co, k, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(B, *S, ci, generator=gen)
    w = torch.randn(co, ci, k, k, k, generator=gen) / (ci * k ** 3) ** 0.5
    b = torch.randn(co, generator=gen)
    g = torch.randn(B, *S, co, generator=gen)
    return x, w, b, g


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("ci,co", CHANNELS)
def test_function_gradients_equal_autograd_of_the_conv(k, ci, co):
    """dx and the bias gradient equal autograd's (the same cuDNN/ATen
    call), dW is within 1e-5 of its largest, the forward is the same call."""
    torch.set_num_threads(1)
    B, S = (2, (3, 5, 7)) if ci * co < 1000 else (1, (5, 3, 3))
    x, w, b, g = _inputs(B, S, ci, co, k)
    pad = (k // 2,) * 3
    xs, ws, bs = (t.clone().requires_grad_() for t in (x, w, b))
    y = convs._Conv3dHandWgrad.apply(xs, ws, bs, pad)
    xr, wr, br = (t.clone().requires_grad_() for t in (x, w, b))
    yr = F.conv3d(to_ncdhw(xr), wr, br, 1, pad, 1, 1)
    assert torch.equal(y, yr)
    to_ndhwc(y).backward(g)
    to_ndhwc(yr).backward(g)
    assert torch.equal(xs.grad, xr.grad)
    assert torch.equal(bs.grad, br.grad)
    err = (ws.grad - wr.grad).abs().max().item()
    assert err <= 1e-5 * wr.grad.abs().max().item(), err


@pytest.mark.parametrize("k", [1, 3])
def test_function_without_bias_or_input_gradient(k):
    """No bias, and an input that asks for no gradient (the image into a
    stem conv): dW alone, no dx."""
    x, w, _, g = _inputs(2, (4, 3, 5), 1, 16, k)
    ws = w.clone().requires_grad_()
    y = convs._Conv3dHandWgrad.apply(x, ws, None, (k // 2,) * 3)
    (dw,) = torch.autograd.grad(to_ndhwc(y), ws, g)
    wr = w.clone().requires_grad_()
    (ref,) = torch.autograd.grad(to_ndhwc(F.conv3d(to_ncdhw(x), wr, None, 1, k // 2)), wr, g)
    assert (dw - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("k", [1, 3])
def test_plain_weight_gradient_is_the_conv_vjp(k):
    """The shifted-slice sum is autograd's weight gradient, in float64."""
    x, w, _, g = _inputs(2, (3, 4, 5), 6, 10, k)
    x, w, g = x.double(), w.double().requires_grad_(), g.double()
    (ref,) = torch.autograd.grad(F.conv3d(to_ncdhw(x), w, padding=k // 2), w, to_ncdhw(g))
    torch.testing.assert_close(conv3d_weight_grad(x, g, k), ref, rtol=1e-12, atol=1e-12)


def _site(ci=16, co=16, k=3, S=(6, 6, 6), dtype=torch.float32):
    return torch.zeros(2, *S, ci, dtype=dtype), torch.zeros(co, ci, k, k, k, dtype=dtype)


@pytest.mark.parametrize("case,takes", [
    ("dense 3^3", True), ("dense 1^3", True), ("bfloat16", False), ("float64", False),
    ("depthwise", False), ("stride 2", False), ("dilation 3", False), ("5^3", False),
    ("2^3 patch embedding", False), ("1x3x3", False), ("no padding", False)])
def test_dispatch_takes_dense_unit_stride_convs_only(case, takes):
    x, w = _site()
    st, pad, dil, groups = (1, 1, 1), (1, 1, 1), (1, 1, 1), 1
    if case == "dense 1^3":
        x, w = _site(k=1)
        pad = (0, 0, 0)
    elif case in ("bfloat16", "float64"):
        x, w = _site(dtype=getattr(torch, case))
    elif case == "depthwise":
        w, groups = torch.zeros(16, 1, 3, 3, 3), 16
    elif case == "stride 2":
        st = (2, 2, 2)
    elif case == "dilation 3":
        dil, pad = (3, 3, 3), (3, 3, 3)
    elif case == "5^3":
        x, w = _site(k=5)
        pad = (2, 2, 2)
    elif case == "2^3 patch embedding":
        x, w = _site(k=2)
        st, pad = (2, 2, 2), (0, 0, 0)
    elif case == "1x3x3":
        w, pad = torch.zeros(16, 16, 1, 3, 3), (0, 1, 1)
    elif case == "no padding":
        pad = (0, 0, 0)
    assert convs.dense_unit_stride(x, w, st, pad, dil, groups) is takes


@pytest.mark.parametrize("ci,co,k,voxels,takes", [
    (1, 16, 3, 2 * 64 * 128 * 128, True), (16, 16, 3, 2 * 64 * 128 * 128, True),
    (32, 81, 3, 2 * 32 ** 3, True), (64, 81, 3, 2 * 16 ** 3, True),
    (96, 48, 3, 2 * 96 ** 3, True), (128, 81, 3, 2 * 8 ** 3, False),
    (128, 128, 3, 2 * 8 ** 3, False), (96, 96, 3, 2 * 24 ** 3, False),
    (768, 768, 3, 2 * 27, False), (16, 14, 1, 2 * 64 * 128 * 128, True),
    (128, 128, 1, 2 * 8 ** 3, True), (384, 192, 1, 2 * 12 ** 3, True),
    (256, 256, 1, 2 * 4 ** 3, False), (768, 384, 1, 2 * 6 ** 3, False),
    (16, 16, 5, 2 * 32 ** 3, False)])
def test_shape_rule_follows_the_measured_table(ci, co, k, voxels, takes):
    """`hand_wgrad_shape` at shapes of the two training cells, as phase 26
    measured them (PERF.md §6)."""
    assert convs.hand_wgrad_shape(ci, co, k, voxels) is takes


def _on_card(monkeypatch):
    """`conv3d` as on the card: tensors report `is_cuda`, and the kernel is
    the plain version, with its calls counted."""
    calls = []

    def kernel(x, g, k):
        calls.append(tuple(x.shape) + (g.shape[-1], k))
        return conv3d_weight_grad(x, g, k)

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(kernels, "conv3d_wgrad", kernel)
    return calls


def _hand(y) -> bool:
    """Whether `conv3d`'s output (its channels-last view) comes from the
    Function."""
    return "Conv3dHandWgrad" in type(y.grad_fn.next_functions[0][0]).__name__


def test_dispatch_engages_only_where_the_weight_gradient_is_asked(monkeypatch):
    """On the card: the weight's gradient asked → the Function, one kernel
    call in the backward; under `no_grad`, or with a weight that asks for
    none, `F.conv3d` alone and no call."""
    x, w, b, g = _inputs(2, (4, 5, 6), 16, 16, 3)
    calls = _on_card(monkeypatch)
    wl = w.clone().requires_grad_()
    y = convs.conv3d(x, wl, b)
    assert _hand(y)
    y.backward(g)
    assert calls == [(2, 4, 5, 6, 16, 16, 3)]
    with torch.no_grad():
        assert convs.conv3d(x, wl, b).grad_fn is None
    xl = x.clone().requires_grad_()
    y = convs.conv3d(xl, w, b)
    assert not _hand(y)
    y.backward(g)
    assert not _hand(convs.conv3d(x, wl, b, stride=2))
    assert not _hand(convs.conv3d(x.double(), wl.double(), b.double()))
    assert len(calls) == 1


def test_no_kernel_call_under_no_grad_through_a_block(monkeypatch):
    """A UnetResBlock (two 3³ convs and a 1³ residual conv): three kernel
    calls in a training backward, none in a `no_grad` forward; the
    gradients those of the plain path."""
    torch.manual_seed(0)
    block = UnetResBlock(8, 16, 3, 1, "instance")
    init_parameters(block, torch.Generator().manual_seed(1))
    x = torch.randn(2, 8, 8, 9, 8)   # 1152 voxels: the 1³ conv in the region too
    ref = torch.autograd.grad(block(x).square().sum(), list(block.parameters()))
    calls = _on_card(monkeypatch)
    with torch.no_grad():
        block(x)
    assert calls == []
    got = torch.autograd.grad(block(x).square().sum(), list(block.parameters()))
    assert len(calls) == 3
    for a, r in zip(got, ref):
        assert (a - r).abs().max().item() <= 1e-5 * max(1.0, r.abs().max().item())


@pytest.fixture(scope="module")
def cell_sites():
    """The two training cells' dense weight-gradient sites, at full size."""
    return {"synapse3d.train": train_path.dense_wgrad_sites(
                dlka_former_synapse(14, do_ds=True, img_size=train_path.PATCH, remat=True,
                                    device="meta"), (train_path.BATCH, *train_path.PATCH, 1)),
            "swin_unetr.train": train_path.dense_wgrad_sites(
                swin_unetr_btcv(14, img_size=(96, 96, 96), feature_size=48, remat=True,
                                device="meta"), (2, 96, 96, 96, 1))}


def test_sites_of_the_training_cells(cell_sites):
    """155 dense stride-1 convs a step in the former (7 in each of 21
    blocks, encoder1's 3, decoder2's 2, out1-out3), 27 in Swin UNETR."""
    assert sum(cell_sites["synapse3d.train"].values()) == 155
    assert sum(cell_sites["swin_unetr.train"].values()) == 27


def test_plans_fit_every_shape_of_the_training_cells(cell_sites):
    """Every plan fits the 227 KB a block may hold (two blocks an SM at
    3³), at most 256 threads, its shared memory the layout's, its parts no
    more than the bricks."""
    for sites in cell_sites.values():
        for (B, D, H, W, ci, co, k) in sites:
            plan = kernels.conv3d_wgrad_plan(B, D, H, W, ci, co, k)
            p = list(plan.params)
            tci = 4 if ci % 4 == 0 else 1
            assert plan.smem_bytes <= kernels._SMEM_TWO_BLOCKS <= 232448
            assert plan.smem_bytes == kernels.conv3d_wgrad_smem_bytes(
                k, tci, p[7], p[8], tuple(p[9:12]), p[13], p[15]) == p[16]
            assert p[14] == p[7] // 4 * (p[8] // tci) * k * k and p[13] == p[14] * p[15] <= 256
            bricks = B * -(-D // p[9]) * -(-H // p[10]) * -(-W // p[11])
            assert 1 <= plan.parts == p[12] <= bricks


def test_launches_per_step_match_the_sites(cell_sites):
    """The tables' kernel-7 launches are the sites in `hand_wgrad_shape`'s
    region: a training step of the former (`train_path`, `trainer_path`),
    of Swin UNETR, a Pancreas iteration."""
    n = train_path.hand_wgrads(cell_sites["synapse3d.train"])
    assert train_path.LAUNCHES_PER_STEP["conv3d_wgrad"] == n == 116
    assert trainer_path.LAUNCHES_PER_STEP["conv3d_wgrad"] == n
    assert "conv3d_wgrad" not in trainer_path.LAUNCHES_PER_VAL_BATCH
    assert train_path.hand_wgrads(cell_sites["swin_unetr.train"]) == 14
    pancreas = train_path.dense_wgrad_sites(dlka_net_pancreas(2, device="meta"),
                                            (trainer_path.BATCH, 96, 96, 96, 1))
    assert (trainer_path.PANCREAS_LAUNCHES_PER_ITERATION["conv3d_wgrad"]
            == train_path.hand_wgrads(pancreas))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,ci,co,k", [(2, (5, 7, 9), 16, 16, 3), (1, (9, 6, 5), 1, 16, 3),
                                         (2, (6, 7, 5), 16, 14, 1), (2, (4, 5, 6), 32, 81, 3),
                                         (1, (3, 3, 3), 48, 48, 3), (2, (7, 5, 6), 6, 10, 3)])
def test_kernel_matches_the_plain_version_on_the_card(monkeypatch, B, S, ci, co, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    x, _, _, g = (t.cuda() for t in _inputs(B, S, ci, co, k))
    before = kernels.conv3d_wgrad.launches
    got = kernels.conv3d_wgrad(x, g, k)
    assert kernels.conv3d_wgrad.launches == before + 1
    ref = conv3d_weight_grad(x.double(), g.double(), k)
    assert ((got.double() - ref).norm() / ref.norm()).item() <= 1e-6
    assert torch.equal(got, kernels.conv3d_wgrad(x, g, k))
