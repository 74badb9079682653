"""Swin UNETR (`models/swin_unetr.py`, `nn/swin3d.py`) on the CPU against
the benchmark's plain reference (`portbench/reference/swin_unetr_btcv.py`),
on seeded random weights at feature size 12 and 3 classes.

The 32³ input pads the 16³ stage to 21³, shifts and masks the 8³ stage
padded to 14³, clamps the window at 4³ and 2³ (the `[:n, :n]` index), and
merges at every stage; the 32×32×64 input adds a stage whose window and
shift are clamped on two axes only (4×4×8: window 4×4×7, shift 0, 0, 3).
Also: the shift mask against a brute-force reading of a rolled map, the
27-region layout, remat, the state-dict keys, the sliding window, the
training step's single-output loss (one process and two gloo ranks), and
the Swin spans and window counter.
"""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deformablelka_tpu_torch import profiling
from deformablelka_tpu_torch.inference.sliding_window import SlidingWindowInference
from deformablelka_tpu_torch.models.swin_unetr import swin_unetr_btcv
from deformablelka_tpu_torch.nn import swin3d
from deformablelka_tpu_torch.nn.layers import init_parameters
from deformablelka_tpu_torch.parallel import make_mesh, shard_batch
from deformablelka_tpu_torch.parallel.launch import run_ranks
from deformablelka_tpu_torch.training.losses import dc_and_ce_loss
from deformablelka_tpu_torch.training.train_step import loss_of, make_sgd, make_train_step
from portbench import harness
from portbench.reference import swin_unetr_btcv as R

SMALL = dict(feature_size=12, num_classes=3)


def _cfg(img):
    return dict(harness.load_json(harness.ROOT / "configs" / "swin_unetr_btcv.json"),
                img_size=list(img), **SMALL)


def _model(img, seed, remat=False):
    """The program at feature size 12 with the state the reference draws
    from `seed` (tables N(0, 1)), and that state."""
    state = harness.make_state(R.param_shapes(_cfg(img)), seed, "cpu")
    model = swin_unetr_btcv(3, img_size=img, feature_size=12, remat=remat, device="cpu")
    model.load_state_dict(state)
    return model, state


def _batch(img, seed, b=2):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, *img, 1, generator=g), torch.randint(0, 3, (b, *img), generator=g)


def test_the_state_dict_is_the_references():
    cfg = _cfg((32, 32, 32))
    model = swin_unetr_btcv(3, img_size=(32, 32, 32), feature_size=12, device="cpu")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == {k: tuple(s) for k, (s, _) in R.param_shapes(cfg).items()}
    assert "swinViT.layers1.0.blocks.0.attn.relative_position_bias_table" in got
    assert "encoder1.layer.conv1.conv.weight" in got and "out.conv.conv.bias" in got
    full = R.param_shapes(harness.load_json(harness.ROOT / "configs" / "swin_unetr_btcv.json"))
    assert sum(math.prod(s) for s, _ in full.values()) == 62_187_296


@pytest.mark.parametrize("img,seed", [((32, 32, 32), 4), ((32, 32, 64), 5)])
def test_logits_loss_and_gradients_match_the_reference(img, seed):
    """The reference runs in float64, so each gap is the program's float32
    rounding: logits within 1e-4 of their largest magnitude and the loss
    within 1e-5 relative (measured ≤ 1e-6); each parameter's gradient
    within 1e-3 of the larger of its norm and the median leaf's (measured
    ≤ 5e-5: the instance norms over 1-8 voxels at the bottom of the
    decoder amplify rounding; the reference itself in float32 reads up to
    1e-3)."""
    cfg = _cfg(img)
    model, state = _model(img, seed)
    x, y = _batch(img, seed + 1)
    loss = loss_of(model, x, y)
    loss.backward()
    q = {k: v.double().requires_grad_(True) for k, v in state.items()}
    ref_loss = R.loss(q, cfg, x.double(), y)
    ref_loss.backward()
    with torch.no_grad():
        logits = model(x)
        ref = R.forward(state | {k: v.detach() for k, v in q.items()}, cfg,
                        x.double().movedim(-1, 1)).movedim(1, -1)
    assert (logits - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert float(loss.detach()) == pytest.approx(float(ref_loss.detach()), rel=1e-5)
    norms = {k: float(v.grad.norm()) for k, v in q.items()}
    med = sorted(norms.values())[len(norms) // 2]
    for k, p in model.named_parameters():
        assert float((p.grad.double() - q[k].grad).norm()) <= 1e-3 * max(norms[k], med), k


def test_remat_changes_nothing():
    """Loss and gradients bitwise equal, but the bias tables' gradients:
    their index backward sums over repeated indices in an order that may
    differ between two calls (measured 9e-8 relative)."""
    img = (32, 32, 32)
    x, y = _batch(img, 8)
    out = []
    for remat in (False, True):
        model, _ = _model(img, 7, remat)
        loss = loss_of(model, x, y)
        loss.backward()
        out.append((loss.detach(), {k: p.grad for k, p in model.named_parameters()}))
    assert torch.equal(out[0][0], out[1][0])
    for k, g in out[0][1].items():
        if k.endswith("relative_position_bias_table"):
            assert float((g - out[1][1][k]).norm()) <= 1e-6 * float(g.norm()), k
        else:
            assert torch.equal(g, out[1][1][k]), k


def _brute_force_mask(dims, ws, shift):
    """(nW, n, n): 0 where two tokens of a window of the rolled map lie as
    far apart in the unrolled map as in the rolled one on every axis (no
    wrap between them), −100 elsewhere."""
    grid = np.stack(np.meshgrid(*(np.arange(n) for n in dims), indexing="ij"), -1)
    rolled = np.roll(grid, [-s for s in shift], (0, 1, 2))
    wins = []
    for d in range(0, dims[0], ws[0]):
        for h in range(0, dims[1], ws[1]):
            for w in range(0, dims[2], ws[2]):
                sl = (slice(d, d + ws[0]), slice(h, h + ws[1]), slice(w, w + ws[2]))
                src = rolled[sl].reshape(-1, 3)
                at = grid[sl].reshape(-1, 3)
                same = ((src[:, None] - src[None]) == (at[:, None] - at[None])).all(-1)
                wins.append(np.where(same, 0.0, -100.0))
    return np.stack(wins)


@pytest.mark.parametrize("dims,ws,shift", [((21, 21, 21), (7, 7, 7), (3, 3, 3)),
                                          ((14, 14, 21), (7, 7, 7), (3, 3, 3)),
                                          ((4, 4, 14), (4, 4, 7), (0, 0, 3))])
def test_shift_mask_by_brute_force(dims, ws, shift):
    want = _brute_force_mask(dims, ws, shift)
    assert np.array_equal(swin3d.shift_mask(dims, ws, shift).numpy(), want)
    ref_labels = R.region_labels(dims, ws, shift, "cpu")
    lab = swin3d.window_partition(ref_labels[None, ..., None], ws)[..., 0]
    assert np.array_equal(np.where(lab[:, :, None] != lab[:, None, :], -100.0, 0.0), want)


@pytest.mark.parametrize("dims", [(21, 21, 21), (14, 14, 21)])
def test_twenty_seven_regions(dims):
    """Per axis the regions 0:-7, -7:-3 and -3: of the padded map; a
    region holds the product of its three lengths."""
    for labels in (swin3d.region_labels(dims, (7, 7, 7), (3, 3, 3)),
                   R.region_labels(dims, (7, 7, 7), (3, 3, 3), "cpu")):
        values, sizes = np.unique(labels.numpy(), return_counts=True)
        assert len(values) == 27
        lengths = [(n - 7, 4, 3) for n in dims]
        want = sorted(a * b * c for a in lengths[0] for b in lengths[1] for c in lengths[2])
        assert sorted(sizes) == want


@pytest.mark.parametrize("ws", [(4, 4, 4), (2, 2, 2), (4, 4, 7)])
def test_a_clamped_window_reads_the_first_rows_of_the_full_index(ws):
    """MONAI indexes the 13³ table of a window clamped to n tokens with
    `relative_position_index[:n, :n]` of the 7³ window, not with the index
    of the clamped window's own offsets: the program and the reference
    both do so."""
    n = math.prod(ws)
    attn = swin3d.WindowAttention(12, 3, (7, 7, 7))
    init_parameters(attn, torch.Generator().manual_seed(0))
    torch.nn.init.normal_(attn.relative_position_bias_table)
    full = torch.from_numpy(swin3d.relative_position_index((7, 7, 7))[:n, :n])
    table = attn.relative_position_bias_table
    want = table[full.reshape(-1)].view(n, n, 3).permute(2, 0, 1)
    assert torch.equal(R.relative_bias(table, n, 7, "cpu"), want)
    x = torch.randn(2, n, 12)
    with torch.no_grad():
        got = attn(x)
        q, k, v = attn.qkv(x).view(2, n, 3, 3, 4).permute(2, 0, 3, 1, 4)
        a = torch.softmax(q @ k.transpose(-2, -1) * 0.5 + want, -1) @ v
        torch.testing.assert_close(got, attn.proj(a.transpose(1, 2).reshape(2, n, 12)))
    own = np.stack(np.meshgrid(*(np.arange(w) for w in ws), indexing="ij")).reshape(3, -1)
    off = own[:, :, None] - own[:, None, :] + 6
    assert not np.array_equal((off[0] * 13 + off[1]) * 13 + off[2], full.numpy())


def test_the_sliding_window_takes_the_model():
    model, _ = _model((32, 32, 32), 3)
    sw = SlidingWindowInference(model, (32, 32, 32), 3, do_mirroring=False, device="cpu")
    x = np.random.default_rng(0).standard_normal((32, 32, 32, 1)).astype(np.float32)
    with torch.no_grad():
        want = torch.softmax(model(torch.from_numpy(x)[None]), -1)[0].numpy()
    np.testing.assert_allclose(sw.predict(x), want, rtol=0, atol=1e-6)
    labels = sw.predict_segmentation(np.zeros((40, 33, 32, 1), np.float32))
    assert labels.shape == (40, 33, 32) and labels.dtype == np.uint8


class OneTensor(torch.nn.Module):
    """A 1³ conv to 3 classes: one tensor of logits, no deep supervision."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(1, 3)
        with torch.no_grad():
            self.lin.weight.copy_(torch.tensor([[1.0], [-2.0], [0.5]]))
            self.lin.bias.copy_(torch.tensor([0.1, 0.0, -0.3]))

    def forward(self, x):
        return self.lin(x)


def test_a_one_tensor_model_is_scored_as_one_scale():
    x, y = _batch((4, 4, 4), 1, b=4)
    model = OneTensor()
    with torch.no_grad():
        want = float(dc_and_ce_loss(model(x), y))
    assert float(loss_of(model, x, y).detach()) == want
    step = make_train_step(model, make_sgd(model.parameters(), 0.1))
    assert float(step(x, y)["loss"]) == want


def _one_tensor_ranks(rank, world):
    mesh = make_mesh(("data",), device_type="cpu")
    x, y = _batch((4, 4, 4), 1, b=4)
    local = shard_batch(mesh, {"image": x, "label": y})
    model = OneTensor()
    step = make_train_step(model, make_sgd(model.parameters(), 0.1), mesh=mesh)
    return float(step(local["image"], local["label"])["loss"])


def test_a_one_tensor_model_is_scored_as_one_scale_across_ranks(tmp_path):
    """Two gloo ranks, each half of the batch: the step's loss is the
    global batch's `dc_and_ce_loss`."""
    x, y = _batch((4, 4, 4), 1, b=4)
    with torch.no_grad():
        want = float(dc_and_ce_loss(OneTensor()(x), y))
    for loss in run_ranks(_one_tensor_ranks, 2, tmp_path):
        assert loss == pytest.approx(want, rel=1e-6)


# ---------------------------------------------------------------- spans and counter

WINDOWS_32 = 2 * (27 * 2 + 8 * 2 + 1 * 2 + 1 * 2)   # B = 2, per forward


@pytest.fixture
def fresh_spans():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _names(recs, name):
    return [r for r in recs if r.name == name]


@pytest.mark.parametrize("remat", [False, True])
def test_swin_spans_and_window_count_in_a_step(fresh_spans, remat):
    img = (32, 32, 32)
    model, _ = _model(img, 2, remat)
    step = make_train_step(model, make_sgd(model.parameters(), 1e-3))
    x, y = _batch(img, 3)
    with profile(activities=[ProfilerActivity.CPU]):
        step(x, y)
    recs = profiling.spans()
    stages = _names(recs, "dlka.swin.stage")
    assert [r.args["stage"] for r in stages] == [0, 1, 2, 3]
    assert [r.args["grid"] for r in stages] == [(21,) * 3, (14,) * 3, (4,) * 3, (2,) * 3]
    assert [r.args["shift"] for r in stages] == [(3,) * 3, (3,) * 3, (0,) * 3, (0,) * 3]
    assert [r.args["windows"] for r in stages] == [54, 16, 2, 2]
    assert all(r.parent.name == "dlka.step.forward" for r in stages)
    attention = _names(recs, "dlka.swin.attention")
    parents = [r.parent.name for r in attention]
    assert parents[:8] == ["dlka.swin.stage"] * 8
    # the recompute opens each block's attention again, in the backward
    assert parents[8:] == (["dlka.step.backward"] * 8 if remat else [])
    unit = _names(recs, "dlka.step")[0]
    assert unit.counts == {"dlka.swin.windows": WINDOWS_32 * (2 if remat else 1)}
    assert sum(r.args["windows"] for r in attention) == unit.counts["dlka.swin.windows"]


def test_untraced_swin_spans_are_the_shared_no_op(fresh_spans, monkeypatch):
    opened = []
    real = profiling.span
    monkeypatch.setattr(swin3d, "span", lambda *a, **k: opened.append(real(*a, **k)) or opened[-1])
    model, _ = _model((32, 32, 32), 2)
    before = profiling.counts().get("dlka.swin.windows", 0)
    with torch.no_grad():
        model(_batch((32, 32, 32), 3)[0])
    assert len(opened) == 12 and all(s is profiling._OFF for s in opened)
    assert profiling.spans() == []
    assert profiling.counts()["dlka.swin.windows"] - before == WINDOWS_32
