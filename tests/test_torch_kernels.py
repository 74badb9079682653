"""The hand kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips without a CUDA card (decided inside the
test, so every worker collects the same tests). On the card:
`python -m pytest tests/test_torch_kernels.py -m cuda --noconftest`
(`tests/conftest.py` imports JAX). TF32 is off on
both sides. Tolerance: max|kernel − plain| ≤ 1e-4 · max(1, max|plain|),
f32 sums in another order (and, in the deform backward kernel, atomics
in an order that changes from run to run).
"""

from unittest import mock

import pytest
import torch

from deformablelka_tpu_torch import main_path, main_path2d, train_path
from deformablelka_tpu_torch.grad_floor import plain_versions
from deformablelka_tpu_torch.models.dlka_former import dlka_former_synapse
from deformablelka_tpu_torch.nn.blocks3d import DeformConvPack3d, LKA3dDeform
from deformablelka_tpu_torch.nn.layers import init_parameters
from deformablelka_tpu_torch.nn.lka2d import deformableLKABlock, LKABlock
from deformablelka_tpu_torch.ops import kernels
from deformablelka_tpu_torch.nn.transformer3d import TRANSFORMER_BLOCKS
from deformablelka_tpu_torch.ops.deform2d import deform_dw_conv2d as deform2d_plain
from deformablelka_tpu_torch.ops.deform2d import deform_dw_conv2d_backward as deform2d_bwd_plain
from deformablelka_tpu_torch.ops.deform3d import deform_conv3d as deform_plain
from deformablelka_tpu_torch.ops.deform3d import deform_conv3d_backward
from deformablelka_tpu_torch.ops.lka import dw_chain2d as chain2d_plain
from deformablelka_tpu_torch.ops.dwconv3d import depthwise_conv3d_dilated as dw_plain
from deformablelka_tpu_torch.ops.lka import dw_chain3d as chain_plain
from deformablelka_tpu_torch.ops.lka import dw_chain3d_backward

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, ref):
    err = (got - ref).abs().max().item()
    assert err <= 1e-4 * max(1.0, ref.abs().max().item()), err


def _deform_inputs(gen, B, S, Ci, Co, reach=2.5):
    D, H, W = S if isinstance(S, tuple) else (S,) * 3
    x = torch.randn(B, D, H, W, Ci, device="cuda", generator=gen)
    off = (torch.rand(B, D, H, W, 81, device="cuda", generator=gen) * 2 - 1) * reach
    w = torch.randn(3, 3, 3, Ci, Co, device="cuda", generator=gen) / (27 * Ci) ** 0.5
    b = torch.randn(Co, device="cuda", generator=gen)
    return x, off, w, b


@pytest.mark.parametrize("B,S,Ci,Co", [(8, 32, 32, 32), (8, 16, 64, 64),
                                       (8, 8, 128, 128), (8, 4, 256, 256),
                                       (2, 16, 64, 64), (2, 8, 128, 128), (2, 4, 256, 256),
                                       (1, (3, 5, 7), 5, 3), (2, (6, 4, 9), 40, 70),
                                       (2, (5, 7, 9), 36, 20), (1, (4, 6, 5), 6, 10),
                                       (3, (9, 10, 11), 64, 96)])
def test_deform_kernel_matches_plain(cuda, B, S, Ci, Co):
    """The four stage shapes at batch 8 (K unsplit at 32³ and 16³, split
    over taps at 8³ and 4³) and at batch 2 (split 3, 9, 27 ways); voxel
    counts and Co that the tiles do not divide; Ci % 4 ≠ 0 and Co % 4 ≠ 0
    (scalar accesses); Ci over one 32-channel chunk and not a multiple."""
    x, off, w, b = _deform_inputs(cuda, B, S, Ci, Co)
    before = kernels.deform_conv3d.launches
    got = kernels.deform_conv3d(x, off, w, b)
    assert kernels.deform_conv3d.launches == before + 1
    _close(got, deform_plain(x, off, w, b))
    _close(kernels.deform_conv3d(x, off, w), deform_plain(x, off, w))


@pytest.mark.parametrize("reach", [0.05, 8.0])
@pytest.mark.parametrize("B,S,C", [(2, 16, 64), (2, 4, 256), (1, (5, 6, 7), 12)])
def test_deform_kernel_matches_plain_at_small_and_large_offsets(cuda, reach, B, S, C):
    """|Δ| ≤ 0.05 (a trained checkpoint reads 0.034) and |Δ| up to 8 (as
    main_path.drive_gates produces: most samples' corners far outside)."""
    x, off, w, b = _deform_inputs(cuda, B, S, C, C, reach)
    _close(kernels.deform_conv3d(x, off, w, b), deform_plain(x, off, w, b))


@pytest.mark.parametrize("B,S,C", [(8, 32, 32), (8, 4, 256), (2, 8, 128)])
def test_deform_kernel_is_deterministic(cuda, B, S, C):
    """Two calls give bit-identical outputs, with K split over taps too (a
    second pass adds the parts in a fixed order; no float atomics)."""
    x, off, w, b = _deform_inputs(cuda, B, S, C, C)
    assert torch.equal(kernels.deform_conv3d(x, off, w, b), kernels.deform_conv3d(x, off, w, b))


def test_deform_kernel_on_an_unaligned_input_takes_scalar_accesses(cuda):
    C = 8
    buf = torch.randn(2 * 4 * 5 * 6 * C + 1, device="cuda", generator=cuda)
    x = buf[1:].view(2, 4, 5, 6, C)
    assert x.data_ptr() % 16 != 0
    off = (torch.rand(2, 4, 5, 6, 81, device="cuda", generator=cuda) * 2 - 1) * 2.5
    w = torch.randn(3, 3, 3, C, C, device="cuda", generator=cuda) / (27 * C) ** 0.5
    _close(kernels.deform_conv3d(x, off, w), deform_plain(x, off, w))


@pytest.mark.parametrize("B,S,C", [(8, 32, 32), (8, 16, 64), (8, 8, 128),
                                   (8, 4, 256), (2, 32, 32), (2, 16, 64),
                                   (1, (5, 13, 7), 3), (2, (20, 11, 30), 6),
                                   (1, (7, 40, 24), 8), (1, (9, 50, 12), 5),
                                   (2, (4, 5, 6), 8)])
def test_chain_kernel_matches_plain(cuda, B, S, C):
    """The four stage shapes at batch 8 and the two largest at batch 2 (z
    phases cut into runs); planes cut into row bands (40, 50 rows), one of
    them with C % 4 ≠ 0 (scalar accesses); channel counts that the tile does
    not divide (3, 5, 6)."""
    D, H, W = S if isinstance(S, tuple) else (S,) * 3
    x = torch.randn(B, D, H, W, C, device="cuda", generator=cuda)
    w5 = torch.randn(5, 5, 5, 1, C, device="cuda", generator=cuda) / 125 ** 0.5
    w7 = torch.randn(7, 7, 7, 1, C, device="cuda", generator=cuda) / 343 ** 0.5
    b5 = torch.randn(C, device="cuda", generator=cuda)
    b7 = torch.randn(C, device="cuda", generator=cuda)
    before = kernels.dw_chain3d.launches
    got = kernels.dw_chain3d(x, w5, b5, w7, b7)
    assert kernels.dw_chain3d.launches == before + 1
    _close(got, chain_plain(x, w5, b5, w7, b7))


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.randn(1, 4, 4, 4, 8, device="cuda")
    off = torch.zeros(1, 4, 4, 4, 81, device="cuda")
    w = torch.zeros(3, 3, 3, 8, 8, device="cuda")
    with pytest.raises(ValueError):
        kernels.deform_conv3d(x.transpose(1, 2), off, w)
    with pytest.raises(TypeError):
        kernels.deform_conv3d(x.double(), off, w)
    with pytest.raises(ValueError):
        kernels.deform_conv3d(x, off[..., :27], w)
    with pytest.raises(ValueError):
        kernels.deform_conv3d(x, off, w.cpu())
    w5, w7, b = (torch.zeros(5, 5, 5, 1, 8, device="cuda"),
                 torch.zeros(7, 7, 7, 1, 8, device="cuda"),
                 torch.zeros(8, device="cuda"))
    with pytest.raises(ValueError):
        kernels.dw_chain3d(x, w5, b, w5, b)


def test_model_on_the_card_matches_the_cpu_and_counts_launches(cuda):
    img = (16, 32, 32)
    gpu = dlka_former_synapse(14, do_ds=False, img_size=img, seed=0)
    cpu = dlka_former_synapse(14, do_ds=False, img_size=img, seed=0, device="cpu")
    x = torch.randn(2, *img, 1)
    kernels.reset_launches()
    with torch.no_grad():
        got = gpu(x.cuda()).cpu()
        ref = cpu(x)
    assert kernels.deform_conv3d.launches == 21
    assert kernels.dw_chain3d.launches == 21
    _close(got, ref)


def _backward_inputs(gen, B, S, Ci, Co, reach=2.5):
    """Offsets uniform in ±reach, a quarter of them exact integers (0 among
    them), where the gradient is the gather's right derivative."""
    D, H, W = S if isinstance(S, tuple) else (S,) * 3
    x = torch.randn(B, D, H, W, Ci, device="cuda", generator=gen)
    off = (torch.rand(B, D, H, W, 81, device="cuda", generator=gen) * 2 - 1) * reach
    pick = torch.rand(off.shape, device="cuda", generator=gen)
    off = torch.where(pick < 0.25, off.round(), off)
    w = torch.randn(3, 3, 3, Ci, Co, device="cuda", generator=gen) / (27 * Ci) ** 0.5
    g = torch.randn(B, D, H, W, Co, device="cuda", generator=gen)
    return x, off, w, g


@pytest.mark.parametrize("B,S,Ci,Co", [(2, 32, 32, 32), (2, 16, 64, 64),
                                       (2, 8, 128, 128), (2, 4, 256, 256),
                                       (1, (3, 5, 7), 5, 3), (2, (6, 4, 9), 40, 70),
                                       (2, (9, 10, 11), 64, 96), (1, (5, 6, 7), 36, 20),
                                       (1, (13, 3, 6), 33, 7)])
def test_deform_backward_kernel_matches_plain(cuda, B, S, Ci, Co):
    """The four stage shapes at batch 2 (taps in 1, 3, 9, 27 groups, the
    weight GEMM in parts); D, H, W that the brick does not divide; Ci and
    Co not multiples of 4 (scalar accesses) or of 32 (part chunks)."""
    x, off, w, g = _backward_inputs(cuda, B, S, Ci, Co)
    before = kernels.deform_conv3d_bwd.launches
    got = kernels.deform_conv3d_bwd(x, off, w, g)
    assert kernels.deform_conv3d_bwd.launches == before + 1
    for a, r in zip(got, deform_conv3d_backward(x, off, w, g)):
        _close(a, r)


@pytest.mark.parametrize("reach", [0.05, 8.0])
@pytest.mark.parametrize("B,S,C", [(2, 16, 64), (2, 8, 128), (2, 4, 256), (1, (5, 6, 7), 12)])
def test_deform_backward_kernel_at_small_and_large_offsets(cuda, reach, B, S, C):
    """|Δ| ≤ 0.05, the voxels of a brick adding into shared corners (the
    same dx element from many lanes' atomics), and |Δ| up to 8, most
    corners far outside the brick or outside the volume; a quarter of the
    offsets exact integers in both."""
    x, off, w, g = _backward_inputs(cuda, B, S, C, C, reach)
    for a, r in zip(kernels.deform_conv3d_bwd(x, off, w, g),
                    deform_conv3d_backward(x, off, w, g)):
        _close(a, r)


def test_deform_backward_kernel_on_an_unaligned_input_takes_scalar_accesses(cuda):
    C = 8
    _, off, w, g = _backward_inputs(cuda, 2, (4, 5, 6), C, C)
    buf = torch.randn(2 * 4 * 5 * 6 * C + 1, device="cuda", generator=cuda)
    x = buf[1:].view(2, 4, 5, 6, C)
    assert x.data_ptr() % 16 != 0
    for a, r in zip(kernels.deform_conv3d_bwd(x, off, w, g),
                    deform_conv3d_backward(x, off, w, g)):
        _close(a, r)


@pytest.mark.parametrize("B,S,C", [(2, 32, 32), (2, 8, 128)])
def test_deform_backward_kernel_weight_gradient_is_deterministic(cuda, B, S, C):
    """dw's parts (40 of a 32 × 32 tile, 5 of 64 × 64 tiles) are added in a
    fixed order: two calls give the same bits."""
    x, off, w, g = _backward_inputs(cuda, B, S, C, C)
    assert torch.equal(kernels.deform_conv3d_bwd(x, off, w, g)[2],
                       kernels.deform_conv3d_bwd(x, off, w, g)[2])


def _chain_inputs(gen, B, S, C):
    D, H, W = S if isinstance(S, tuple) else (S,) * 3
    x = torch.randn(B, D, H, W, C, device="cuda", generator=gen)
    w5 = torch.randn(5, 5, 5, 1, C, device="cuda", generator=gen) / 125 ** 0.5
    b5 = torch.randn(C, device="cuda", generator=gen)
    w7 = torch.randn(7, 7, 7, 1, C, device="cuda", generator=gen) / 343 ** 0.5
    b7 = torch.randn(C, device="cuda", generator=gen)
    g = torch.randn(B, D, H, W, C, device="cuda", generator=gen)
    return (x, w5, b5, w7, b7), g


def _chain_autograd(args, g):
    """(dx, dw5, db5, dw7, db7): autograd of the plain chain (cuDNN)."""
    leaves = [a.detach().clone().requires_grad_() for a in args]
    return torch.autograd.grad(chain_plain(*leaves), leaves, g)


@pytest.mark.parametrize("B,S,C", [(2, 32, 32), (2, 16, 64), (2, 8, 128), (2, 4, 256),
                                   (2, 48, 32), (2, 24, 64),
                                   (1, (5, 13, 7), 3), (2, (9, 14, 10), 12),
                                   (1, (20, 7, 9), 6), (1, (4, 30, 5), 5)])
def test_chain_backward_kernel_matches_plain(cuda, B, S, C):
    """Each of the five gradients against autograd of the plain chain: the
    four Synapse stages at batch 2 (the dilated pass on whole phase
    sub-grids), two Pancreas stages (48³: its sub-grids cut into bricks);
    sides the bricks do not divide and borders thinner than the dilated
    reach; C % 4 ≠ 0 (scalar accesses) and C below one channel tile. And
    against `dw_chain3d_backward`, the same gradient written out in the
    form the kernel computes (the CPU path, held against JAX there)."""
    args, g = _chain_inputs(cuda, B, S, C)
    before = kernels.dw_chain3d_bwd.launches
    got = kernels.dw_chain3d_bwd(*args, g)
    assert kernels.dw_chain3d_bwd.launches == before + 1
    for a, r, e in zip(got, _chain_autograd(args, g), dw_chain3d_backward(*args, g)):
        assert a.shape == r.shape == e.shape
        _close(a, r)
        _close(a, e)


@pytest.mark.parametrize("B,S,C", [(2, 32, 32), (2, 4, 256), (2, (9, 14, 10), 12)])
def test_chain_backward_kernel_is_deterministic(cuda, B, S, C):
    """No atomics: the weight gradients' per-block sums are added in a fixed
    order, so two calls give the same bits, every output."""
    args, g = _chain_inputs(cuda, B, S, C)
    for a, b in zip(kernels.dw_chain3d_bwd(*args, g), kernels.dw_chain3d_bwd(*args, g)):
        assert torch.equal(a, b)


def test_chain_backward_kernel_on_unaligned_inputs_takes_scalar_accesses(cuda):
    C = 8
    args, _ = _chain_inputs(cuda, 2, (4, 5, 6), C)
    n = 2 * 4 * 5 * 6 * C
    buf = torch.randn(2 * n + 2, device="cuda", generator=cuda)
    x, g = buf[1:n + 1].view(2, 4, 5, 6, C), buf[n + 2:].view(2, 4, 5, 6, C)
    assert x.data_ptr() % 16 != 0 and g.data_ptr() % 16 != 0
    args = (x, *args[1:])
    for a, r in zip(kernels.dw_chain3d_bwd(*args, g), _chain_autograd(args, g)):
        _close(a, r)


def test_chain_backward_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    (x, w5, b5, w7, b7), g = _chain_inputs(cuda, 1, 4, 8)
    with pytest.raises(TypeError):
        kernels.dw_chain3d_bwd(x, w5, b5, w7, b7, g.double())
    with pytest.raises(ValueError):
        kernels.dw_chain3d_bwd(x, w5, b5, w7, b7, g[..., :4])
    with pytest.raises(ValueError):
        kernels.dw_chain3d_bwd(x, w5, b5, w7, b7, g.transpose(1, 2))
    with pytest.raises(ValueError):
        kernels.dw_chain3d_bwd(x.transpose(1, 2), w5, b5, w7, b7, g)
    with pytest.raises(ValueError):
        kernels.dw_chain3d_bwd(x, w5.cpu(), b5, w7, b7, g)
    with pytest.raises(ValueError):
        kernels.dw_chain3d_bwd(x, w7, b5, w5, b7, g)


def test_chain_function_launches_the_backward_kernel(cuda):
    """Autograd through `dw_chain3d` on the card: one forward and one
    backward launch, the plain chain's gradients, and none for an input
    that asks for none."""
    args, g = _chain_inputs(cuda, 2, (6, 9, 7), 8)
    need = (True, True, False, True, True)
    leaves = [a.clone().requires_grad_(n) for a, n in zip(args, need)]
    before = (kernels.dw_chain3d.launches, kernels.dw_chain3d_bwd.launches)
    kernels.dw_chain3d(*leaves).backward(g)
    assert (kernels.dw_chain3d.launches, kernels.dw_chain3d_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert leaves[2].grad is None
    for leaf, r in zip(leaves, _chain_autograd(args, g)):
        if leaf.requires_grad:
            _close(leaf.grad, r)


def test_training_step_launches_match_the_table(cuda):
    """A training step of the published model (remat, deep supervision) at
    16×32×32 launches each kernel as `train_path.LAUNCHES_PER_STEP` says:
    the chain's backward once a block; the dense weight gradient (kernel
    7, whose region depends on the voxels) at the sites in its region at
    this size."""
    path = train_path.build(seed=0, img_size=(16, 32, 32))
    sites = train_path.dense_wgrad_sites(
        dlka_former_synapse(14, do_ds=True, img_size=(16, 32, 32), remat=True, device="meta"),
        (train_path.BATCH, 16, 32, 32, 1))
    kernels.reset_launches()
    train_path.step(path)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {**train_path.LAUNCHES_PER_STEP,
                                       "conv3d_wgrad": train_path.hand_wgrads(sites)}
    assert train_path.LAUNCHES_PER_STEP["dw_chain3d_bwd"] == main_path.BLOCKS


def test_training_step_in_plain_versions_launches_no_hand_kernel(cuda):
    """Inside `grad_floor.plain_versions()` a training step of the
    published model launches none of the table's kernels, the dense convs'
    weight gradient (kernel 7, which `ops.convs` calls) included, so that
    the whole-step checks against the plain versions hold every kernel."""
    path = train_path.build(seed=0, img_size=(16, 32, 32))
    kernels.reset_launches()
    with plain_versions():
        train_path.step(path)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {}


def test_kernel_outputs_carry_a_grad_fn(cuda):
    x = torch.randn(1, 4, 5, 6, 8, device="cuda", requires_grad=True)
    off = torch.zeros(1, 4, 5, 6, 81, device="cuda")
    w = torch.randn(3, 3, 3, 8, 8, device="cuda")
    assert kernels.deform_conv3d(x, off, w).grad_fn is not None
    w5, w7, b = (torch.randn(5, 5, 5, 1, 8, device="cuda"),
                 torch.randn(7, 7, 7, 1, 8, device="cuda"),
                 torch.zeros(8, device="cuda"))
    assert kernels.dw_chain3d(x, w5, b, w7, b).grad_fn is not None


@pytest.mark.parametrize("gate", [DeformConvPack3d, LKA3dDeform])
def test_gate_gradients_on_the_card_match_the_plain_path(cuda, gate):
    """One backward through the module: every parameter (and the input)
    gets the gradient of the plain path, with offsets past ±1."""
    C = 16
    m = gate(C)
    init_parameters(m, torch.Generator().manual_seed(0))
    pack = m if isinstance(m, DeformConvPack3d) else m.deform_conv
    with torch.no_grad():
        pack.conv_offset.weight.normal_(
            0.0, 10.0 / (27 * C) ** 0.5, generator=torch.Generator().manual_seed(1))
    m = m.cuda()
    x = torch.randn(2, 6, 7, 5, C, device="cuda", generator=cuda)
    gy = torch.randn(2, 6, 7, 5, C, device="cuda", generator=cuda)

    def grads():
        m.zero_grad(set_to_none=True)
        xi = x.clone().requires_grad_()
        y = m(xi)
        y.backward(gy)
        return {"input": xi.grad, **{n: p.grad for n, p in m.named_parameters()}}

    before = kernels.deform_conv3d_bwd.launches
    got = grads()
    assert kernels.deform_conv3d_bwd.launches == before + 1
    with mock.patch.object(kernels, "deform_conv3d", deform_plain), \
            mock.patch.object(kernels, "dw_chain3d", chain_plain):
        ref = grads()
    assert sorted(got) == sorted(ref)
    for name in ref:
        assert got[name] is not None and ref[name] is not None, name
        _close(got[name], ref[name])
    assert got["conv_offset.weight" if gate is DeformConvPack3d
               else "deform_conv.conv_offset.weight"].abs().max() > 0


def _offsets_2d(shape, gen, reach=2.5):
    """Offsets uniform in ±reach, a quarter of them exact integers (0 among
    them)."""
    off = (torch.rand(shape, device="cuda", generator=gen) * 2 - 1) * reach
    pick = torch.rand(shape, device="cuda", generator=gen)
    return torch.where(pick < 0.25, off.round(), off)


@pytest.mark.parametrize("B,H,W,C,k,dil", [
    (24, 14, 14, 384, 5, 1), (24, 14, 14, 384, 7, 3), (24, 28, 28, 192, 7, 3),
    (4, 56, 56, 96, 5, 1), (4, 56, 56, 96, 7, 3), (1, 9, 13, 5, 5, 1),
    (2, 7, 5, 40, 7, 3), (1, 10, 12, 33, 3, 2), (24, 28, 28, 192, 5, 1),
    (24, 56, 56, 96, 7, 3), (2, 3, 30, 36, 5, 1), (1, 37, 2, 6, 7, 3)])
def test_deform_dw_kernel_matches_plain(cuda, B, H, W, C, k, dil):
    """The six site shapes (two at batch 4); H and W that the 32-pixel tile
    does not divide; C % 4 ≠ 0 (scalar accesses) and C not a multiple of
    the 32-channel chunk; 14²×384 split into channel parts."""
    x = torch.randn(B, H, W, C, device="cuda", generator=cuda)
    off = _offsets_2d((B, H, W, 2 * k * k), cuda)
    w = torch.randn(k, k, 1, C, device="cuda", generator=cuda) / k
    before = kernels.deform_dw_conv2d.launches
    got = kernels.deform_dw_conv2d(x, off, w, dil)
    assert kernels.deform_dw_conv2d.launches == before + 1
    _close(got, deform2d_plain(x, off, w, dil))


@pytest.mark.parametrize("reach", [0.05, 8.0])
@pytest.mark.parametrize("B,H,W,C,k,dil", [(24, 14, 14, 384, 5, 1), (4, 56, 56, 96, 7, 3),
                                           (1, 9, 13, 5, 5, 1)])
def test_deform_dw_kernel_at_small_and_large_offsets(cuda, reach, B, H, W, C, k, dil):
    """|Δ| ≤ 0.05 (corners shared across the tile) and up to 8 (many
    corners outside the image), a quarter of the offsets exact integers."""
    x = torch.randn(B, H, W, C, device="cuda", generator=cuda)
    off = _offsets_2d((B, H, W, 2 * k * k), cuda, reach)
    w = torch.randn(k, k, 1, C, device="cuda", generator=cuda) / k
    _close(kernels.deform_dw_conv2d(x, off, w, dil), deform2d_plain(x, off, w, dil))


def test_deform_dw_kernel_on_an_unaligned_input_takes_scalar_accesses(cuda):
    C = 8
    buf = torch.randn(2 * 9 * 11 * C + 1, device="cuda", generator=cuda)
    x = buf[1:].view(2, 9, 11, C)
    assert x.data_ptr() % 16 != 0
    off = _offsets_2d((2, 9, 11, 50), cuda)
    w = torch.randn(5, 5, 1, C, device="cuda", generator=cuda) / 5
    _close(kernels.deform_dw_conv2d(x, off, w, 1), deform2d_plain(x, off, w, 1))


def _deform_dw_bwd_inputs(gen, B, H, W, C, k, reach=2.5):
    x = torch.randn(B, H, W, C, device="cuda", generator=gen)
    off = _offsets_2d((B, H, W, 2 * k * k), gen, reach)
    w = torch.randn(k, k, 1, C, device="cuda", generator=gen) / k
    g = torch.randn(B, H, W, C, device="cuda", generator=gen)
    return x, off, w, g


@pytest.mark.parametrize("B,H,W,C,k,dil", [
    (2, 14, 14, 384, 5, 1), (2, 14, 14, 384, 7, 3), (2, 28, 28, 192, 7, 3),
    (2, 56, 56, 96, 5, 1), (1, 9, 13, 5, 5, 1), (2, 7, 5, 40, 7, 3),
    (1, 10, 12, 33, 3, 2), (2, 3, 30, 36, 5, 1), (1, 37, 2, 6, 7, 3),
    (2, 19, 23, 20, 7, 3), (3, 17, 29, 8, 5, 1)]
    + [(B, S, S, C, k, dil) for B in (24, 16) for S, C in ((14, 384), (28, 192), (56, 96))
       for k, dil in ((5, 1), (7, 3))])
def test_deform_dw_backward_kernel_matches_plain(cuda, B, H, W, C, k, dil):
    """The decoder's widths at batch 2 and at the flagship's and the skin
    trainer's full batches (24, 16); channel chunks whose offset gradients
    add with atomics (C = 192, 384); H and W that the tile does not divide,
    so that tiles on each image edge hang over it (19×23, 17×29: several
    tiles a side); C % 4 ≠ 0 (scalar accesses) and C not a multiple of 32;
    offsets in ±2.5, a quarter of them exact integers (the gather's right
    derivative), some corners outside the image."""
    x, off, w, g = _deform_dw_bwd_inputs(cuda, B, H, W, C, k)
    before = kernels.deform_dw_conv2d_bwd.launches
    got = kernels.deform_dw_conv2d_bwd(x, off, w, g, dil)
    assert kernels.deform_dw_conv2d_bwd.launches == before + 1
    for a, r in zip(got, deform2d_bwd_plain(x, off, w, g, dil)):
        _close(a, r)


def _fixed_offsets(shape, gen, reach):
    """Offsets of both signs whose size is fixed by `reach`: "small" in
    ±0.15 and none an integer (a training step's, at initialisation),
    "below" just below an integer (−1.99 or 2.99), "above" just above one
    (−2.01 or 3.01), "far" ±30 and a fraction (every sample far from its tap: most
    corners outside the image, the rest of the image's rows and columns
    far from the block's tile)."""
    sign = torch.rand(shape, device="cuda", generator=gen) < 0.5
    if reach == "small":
        return (torch.rand(shape, device="cuda", generator=gen) * 2 - 1) * 0.15
    if reach == "far":
        size = 30 + torch.rand(shape, device="cuda", generator=gen)
        return torch.where(sign, size, -size)
    lo, hi = {"below": (-1.99, 2.99), "above": (-2.01, 3.01)}[reach]
    return torch.where(sign, torch.full(shape, hi, device="cuda"),
                       torch.full(shape, lo, device="cuda"))


@pytest.mark.parametrize("reach", [0.05, 8.0, "small", "below", "above", "far"])
@pytest.mark.parametrize("B,H,W,C,k,dil", [(2, 14, 14, 384, 5, 1), (2, 56, 56, 96, 7, 3),
                                           (1, 9, 13, 5, 5, 1)])
def test_deform_dw_backward_kernel_at_small_and_large_offsets(cuda, reach, B, H, W, C, k,
                                                              dil):
    """|Δ| ≤ 0.05 (many samples adding into the same dx elements) and up
    to 8 (most corners outside the image, their dx and offset terms
    zero); small offsets none of which is an integer (every corner adds);
    offsets of fixed size just below and just above an integer; offsets
    that take every sample far from its tap."""
    x, off, w, g = _deform_dw_bwd_inputs(cuda, B, H, W, C, k,
                                         reach if isinstance(reach, float) else 2.5)
    if isinstance(reach, str):
        off = _fixed_offsets(off.shape, cuda, reach)
    for a, r in zip(kernels.deform_dw_conv2d_bwd(x, off, w, g, dil),
                    deform2d_bwd_plain(x, off, w, g, dil)):
        _close(a, r)


def test_deform_dw_backward_kernel_on_unaligned_inputs_takes_scalar_accesses(cuda):
    C = 8
    x, off, w, g = _deform_dw_bwd_inputs(cuda, 2, 9, 11, C, 5)
    buf = torch.randn(2 * 9 * 11 * C + 1, device="cuda", generator=cuda)
    g = buf[1:].view(2, 9, 11, C)
    assert g.data_ptr() % 16 != 0
    for a, r in zip(kernels.deform_dw_conv2d_bwd(x, off, w, g, 1),
                    deform2d_bwd_plain(x, off, w, g, 1)):
        _close(a, r)


@pytest.mark.parametrize("B,H,W,C,k,dil", [(4, 28, 28, 192, 7, 3), (2, 14, 14, 384, 5, 1)])
def test_deform_dw_backward_kernel_weight_gradient_is_deterministic(cuda, B, H, W, C, k,
                                                                    dil):
    """dw is a fixed-order sum of per-tile parts: two calls give the same
    bits (dx and doff take atomics in the order the blocks run)."""
    x, off, w, g = _deform_dw_bwd_inputs(cuda, B, H, W, C, k)
    assert torch.equal(kernels.deform_dw_conv2d_bwd(x, off, w, g, dil)[2],
                       kernels.deform_dw_conv2d_bwd(x, off, w, g, dil)[2])


def test_deform_dw_conv2d_backward_launches_the_kernel(cuda):
    """Autograd through `deform_dw_conv2d` on the card runs the backward
    kernel, once, and gives the plain path's gradients."""
    x, off, w, g = _deform_dw_bwd_inputs(cuda, 2, 14, 12, 32, 7)
    leaves = [t.clone().requires_grad_() for t in (x, off, w)]
    before = (kernels.deform_dw_conv2d.launches, kernels.deform_dw_conv2d_bwd.launches)
    kernels.deform_dw_conv2d(*leaves, 3).backward(g)
    assert (kernels.deform_dw_conv2d.launches,
            kernels.deform_dw_conv2d_bwd.launches) == (before[0] + 1, before[1] + 1)
    for t, r in zip(leaves, deform2d_bwd_plain(x, off, w, g, 3)):
        _close(t.grad, r)


@pytest.mark.parametrize("B,H,W,C", [(24, 14, 14, 384), (24, 28, 28, 192),
                                     (4, 56, 56, 96), (1, 5, 7, 3),
                                     (2, 20, 31, 6), (1, 100, 90, 2),
                                     (1, 200, 200, 1), (2, 64, 64, 96),
                                     (2, 33, 10, 12)])
def test_chain2d_kernel_matches_plain(cuda, B, H, W, C):
    """The three decoder shapes; C % 4 ≠ 0 (scalar accesses); H ≠ W; planes
    cut into several row bands (200², 64²); channel counts that the tile
    does not divide (3, 6, 12)."""
    x = torch.randn(B, H, W, C, device="cuda", generator=cuda)
    w5 = torch.randn(5, 5, 1, C, device="cuda", generator=cuda) / 5
    w7 = torch.randn(7, 7, 1, C, device="cuda", generator=cuda) / 7
    b5 = torch.randn(C, device="cuda", generator=cuda)
    b7 = torch.randn(C, device="cuda", generator=cuda)
    before = kernels.dw_chain2d.launches
    got = kernels.dw_chain2d(x, w5, b5, w7, b7)
    assert kernels.dw_chain2d.launches == before + 1
    _close(got, chain2d_plain(x, w5, b5, w7, b7))


def test_2d_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.randn(1, 6, 6, 8, device="cuda")
    off = torch.zeros(1, 6, 6, 50, device="cuda")
    w = torch.zeros(5, 5, 1, 8, device="cuda")
    with pytest.raises(ValueError):
        kernels.deform_dw_conv2d(x.transpose(1, 2), off, w, 1)
    with pytest.raises(TypeError):
        kernels.deform_dw_conv2d(x.double(), off, w, 1)
    with pytest.raises(ValueError):
        kernels.deform_dw_conv2d(x, off[..., :18], w, 1)
    with pytest.raises(ValueError):
        kernels.deform_dw_conv2d(x, torch.zeros(1, 6, 6, 32, device="cuda"),
                                 torch.zeros(4, 4, 1, 8, device="cuda"), 1)
    w5, w7, b = (torch.zeros(5, 5, 1, 8, device="cuda"),
                 torch.zeros(7, 7, 1, 8, device="cuda"),
                 torch.zeros(8, device="cuda"))
    with pytest.raises(ValueError):
        kernels.dw_chain2d(x, w5, b, w5, b)
    with pytest.raises(ValueError):
        kernels.dw_chain2d(x, w5, b.cpu(), w7, b)
    with pytest.raises(ValueError):  # a band of one channel exceeds shared memory
        kernels.dw_chain2d(torch.zeros(1, 14, 2000, 1, device="cuda"),
                           w5[..., :1], b[:1], w7[..., :1], b[:1])


@pytest.mark.parametrize("block", [deformableLKABlock, LKABlock])
def test_2d_block_gradients_on_the_card_match_the_plain_path(cuda, block):
    """One backward through an LKA block: every parameter (and the input)
    gets the gradient of the plain path, with offsets past ±1."""
    C = 32
    m = block(C)
    init_parameters(m, torch.Generator().manual_seed(0))
    main_path2d.drive_gates_2d(m, seed=1)
    m = m.cuda()
    x = torch.randn(2, 14, 12, C, device="cuda", generator=cuda)
    gy = torch.randn(2, 14, 12, C, device="cuda", generator=cuda)

    def grads():
        m.zero_grad(set_to_none=True)
        xi = x.clone().requires_grad_()
        m(xi).backward(gy)
        return {"input": xi.grad, **{n: p.grad for n, p in m.named_parameters()}}

    before = kernels.deform_dw_conv2d.launches + kernels.dw_chain2d.launches
    got = grads()
    assert kernels.deform_dw_conv2d.launches + kernels.dw_chain2d.launches == before + (
        2 if block is deformableLKABlock else 1)
    with mock.patch.object(kernels, "deform_dw_conv2d", deform2d_plain), \
            mock.patch.object(kernels, "dw_chain2d", chain2d_plain):
        ref = grads()
    assert sorted(got) == sorted(ref)
    for name in ref:
        assert got[name] is not None and ref[name] is not None, name
        _close(got[name], ref[name])


@pytest.mark.parametrize("config", main_path2d.FLAGSHIP)
def test_2d_models_on_the_card_match_the_cpu_and_count_launches(cuda, config):
    gpu, _ = main_path2d.build(config, seed=0, img_size=64)
    cpu, _ = main_path2d.build(config, seed=0, device="cpu", img_size=64)
    x = torch.randn(2, 64, 64, 1)
    kernels.reset_launches()
    with torch.no_grad():
        got = gpu(x.cuda()).cpu()
        ref = cpu(x)
    assert kernels.launch_counts() == main_path2d.LAUNCHES_PER_FORWARD[config]
    _close(got, ref)


@pytest.mark.parametrize("B,S,C,K,dil", [(8, 8, 128, 5, 3), (8, 4, 256, 3, 2),
                                         (2, (10, 14, 22), 8, 7, 3), (1, 4, 32, 5, 3),
                                         (2, (5, 9, 6), 40, 3, 1), (1, (9, 10, 11), 3, 5, 2),
                                         (2, (6, 7, 13), 12, 3, 1), (1, (20, 24, 28), 16, 5, 3)])
def test_dwconv3d_kernel_matches_plain(cuda, B, S, C, K, dil):
    """The two site shapes; volumes cut into several tiles; C % 4 ≠ 0
    (scalar copies); channel counts that the tile does not divide (3, 12)."""
    D, H, W = S if isinstance(S, tuple) else (S,) * 3
    x = torch.randn(B, D, H, W, C, device="cuda", generator=cuda)
    w = torch.randn(K, K, K, 1, C, device="cuda", generator=cuda) / K ** 1.5
    b = torch.randn(C, device="cuda", generator=cuda)
    before = kernels.dwconv3d.launches
    got = kernels.dwconv3d(x, w, b, dil)
    assert kernels.dwconv3d.launches == before + 1
    _close(got, dw_plain(x, w, b, dil))
    _close(kernels.dwconv3d(x, w, None, dil), dw_plain(x, w, None, dil))


def test_kernels_5_6_on_an_unaligned_input_take_scalar_accesses(cuda):
    """An input whose data does not start on 16 bytes (a view at an offset)
    goes through the kernels' scalar path, with the same result; the 3D
    chain too."""
    C = 8
    buf = torch.randn(2 * 5 * 9 * 11 * C + 1, device="cuda", generator=cuda)
    x = buf[1:].view(2, 5, 9, 11, C)
    w5 = torch.randn(5, 5, 5, 1, C, device="cuda", generator=cuda) / 125 ** 0.5
    w7 = torch.randn(7, 7, 7, 1, C, device="cuda", generator=cuda) / 343 ** 0.5
    b = torch.randn(C, device="cuda", generator=cuda)
    _close(kernels.dw_chain3d(x, w5, b, w7, b), chain_plain(x, w5, b, w7, b))
    buf = torch.randn(2 * 9 * 11 * C + 1, device="cuda", generator=cuda)
    x = buf[1:].view(2, 9, 11, C)
    assert x.data_ptr() % 16 != 0
    w5 = torch.randn(5, 5, 1, C, device="cuda", generator=cuda) / 5
    w7 = torch.randn(7, 7, 1, C, device="cuda", generator=cuda) / 7
    b = torch.randn(C, device="cuda", generator=cuda)
    _close(kernels.dw_chain2d(x, w5, b, w7, b), chain2d_plain(x, w5, b, w7, b))
    buf = torch.randn(2 * 6 * 5 * 7 * C + 1, device="cuda", generator=cuda)
    x = buf[1:].view(2, 6, 5, 7, C)
    w = torch.randn(3, 3, 3, 1, C, device="cuda", generator=cuda) / 5
    _close(kernels.dwconv3d(x, w, b, 2), dw_plain(x, w, b, 2))


def test_kernels_5_6_dispatch_lean_without_grad(cuda):
    """Under no_grad, or with no input requiring a gradient, the kernels
    launch with no autograd Function around them; with one, the output
    carries a grad_fn. Each call counts one launch."""
    x = torch.randn(2, 9, 11, 8, device="cuda", generator=cuda)
    w5, w7, b = (torch.randn(5, 5, 1, 8, device="cuda"), torch.randn(7, 7, 1, 8, device="cuda"),
                 torch.zeros(8, device="cuda"))
    x3 = torch.randn(2, 4, 4, 4, 8, device="cuda", generator=cuda)
    w3 = torch.randn(3, 3, 3, 1, 8, device="cuda")
    before = (kernels.dw_chain2d.launches, kernels.dwconv3d.launches)
    with torch.no_grad():
        assert kernels.dw_chain2d(x.requires_grad_(), w5, b, w7, b).grad_fn is None
        assert kernels.dwconv3d(x3.requires_grad_(), w3, b, 2).grad_fn is None
    assert kernels.dw_chain2d(x.detach(), w5, b, w7, b).grad_fn is None
    assert kernels.dw_chain2d(x, w5, b, w7, b).grad_fn is not None
    assert kernels.dwconv3d(x3, w3, None, 2).grad_fn is not None
    assert (kernels.dw_chain2d.launches, kernels.dwconv3d.launches) == (
        before[0] + 3, before[1] + 2)


def test_dwconv3d_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.randn(1, 4, 4, 4, 8, device="cuda")
    w = torch.zeros(3, 3, 3, 1, 8, device="cuda")
    b = torch.zeros(8, device="cuda")
    with pytest.raises(ValueError):  # even K
        kernels.dwconv3d(x, torch.zeros(4, 4, 4, 1, 8, device="cuda"), b, 2)
    with pytest.raises(ValueError):  # not cubic
        kernels.dwconv3d(x, torch.zeros(3, 3, 5, 1, 8, device="cuda"), b, 2)
    with pytest.raises(ValueError):
        kernels.dwconv3d(x.transpose(1, 2), w, b, 2)
    with pytest.raises(TypeError):
        kernels.dwconv3d(x.double(), w.double(), b.double(), 2)
    with pytest.raises(ValueError):
        kernels.dwconv3d(x, w[..., :4], b, 2)
    with pytest.raises(ValueError):
        kernels.dwconv3d(x, w, b.cpu(), 2)


def test_dwconv3d_gradient_on_the_card_matches_the_plain_path(cuda):
    x = torch.randn(2, 8, 8, 8, 128, device="cuda", generator=cuda)
    w = torch.randn(5, 5, 5, 1, 128, device="cuda", generator=cuda) / 5 ** 1.5
    b = torch.randn(128, device="cuda", generator=cuda)
    gy = torch.randn(x.shape, device="cuda", generator=cuda)

    def grads(fn):
        ins = [t.clone().requires_grad_() for t in (x, w, b)]
        fn(*ins, 3).backward(gy)
        return [t.grad for t in ins]

    before = kernels.dwconv3d.launches
    got = grads(kernels.dwconv3d)
    assert kernels.dwconv3d.launches == before + 1
    for a, r in zip(got, grads(dw_plain)):
        _close(a, r)


@pytest.mark.parametrize("name,S,C", [(n, 4, 32) for n in TRANSFORMER_BLOCKS]
                         + [(n, S, C) for n in ("TransformerBlock_Deform_LKA_Spatial_sequential",
                                                "TransformerBlock_Deform_LKA_Channel_sequential")
                            for S, C in ((8, 128), (4, 256))])
def test_block_on_the_card_matches_the_cpu(cuda, name, S, C):
    cpu = TRANSFORMER_BLOCKS[name](S ** 3, C, 16).eval()
    init_parameters(cpu, torch.Generator().manual_seed(0))
    main_path.drive_gates(cpu, seed=1)
    main_path2d.drive_gates_2d(cpu, seed=2)
    gpu = TRANSFORMER_BLOCKS[name](S ** 3, C, 16).eval()
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.cuda()
    x = torch.randn(2, S, S, S, C)
    kernels.reset_launches()
    with torch.no_grad():
        got = gpu(x.cuda()).cpu()
        ref = cpu(x)
    if name.endswith("_sequential"):
        assert kernels.dwconv3d.launches == (1 if C >= 128 else 0)
    _close(got, ref)
