"""The 2D recipe on the port's training step, and the cell `maxvit2d.train`.

On the CPU (tier-1):
- `train_step.sgd_update`, the update the step's graphs capture (SGD's
  arithmetic by `torch._fused_sgd_`, each group's LR a 0-d tensor),
  against `torch.optim.SGD.step` over 3 steps with a new LR each, after
  a first step by `torch.optim.SGD` (which makes the momentum buffers):
  the 2D recipe (momentum 0.9, weight decay 1e-4) and the 3D one
  (Nesterov 0.99, weight decay 3e-5). Tolerance: the fused kernel rounds
  each parameter and buffer once per step where the foreach step rounds
  every intermediate, and takes the LR in float32; the two stay within
  8 float32 ulps (2⁻²⁰ relative) of each tensor's largest element;
- `make_train_step(..., clip=None)`: a parameter the loss does not reach
  gets a zero gradient, so weight decay and momentum still move it;
- the spans `dlka.maxvit.attention` (22 a forward, block and grid in
  turn) and `dlka.lka2d` (6), and the counter `dlka.maxvit.windows`:
  B·2·(2·64 + 2·16 + 5·4 + 2·1) at 64², as at 224²;
- the cell `maxvit2d.train` at `portbench/tests/conftest.TRAIN2D_SMALL`'s
  sizes, driven through `run.prepare` and its loop: correct against the
  plain reference within `limits/maxvit2d.train.json`, and its
  end-to-end metric exactly `train_step_s`.

Marked `cuda` (each test skips without a card; on the card: `python -m
pytest tests/test_torch_trainer2d_graph_step.py -m cuda --noconftest -q
-p no:cacheprovider`, since `tests/conftest.py` imports JAX): the update
on the card against `torch.optim.SGD` as above, and the cell at full
size (224², B = 24): `Trainer2D` serves step 3 by replay, five steps with
five LRs capture once, and the checked steps agree with the reference
within the cell's limits.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deformablelka_tpu_torch import profiling
from deformablelka_tpu_torch.models.maxvit_dlka import maxvit_dlka_former
from deformablelka_tpu_torch.training import train_step as ts
from deformablelka_tpu_torch.training.losses import dice_ce_2d_loss
from deformablelka_tpu_torch.training.train_step import GRAPHED, make_train_step, sgd_update
from portbench import harness, run
from portbench.tests.conftest import TRAIN2D_SMALL

torch.set_num_threads(1)
CELL = "maxvit2d.train"
ULPS8 = 2.0 ** -20
RECIPES = {"2d": dict(momentum=0.9, weight_decay=1e-4, nesterov=False),
           "3d": dict(momentum=0.99, weight_decay=3e-5, nesterov=True)}


@pytest.fixture(autouse=True)
def fresh_spans():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


def _close(got, want):
    tol = ULPS8 * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


def _sgd_against_torch(recipe, device):
    g = torch.Generator().manual_seed(7)
    start = [torch.randn(s, generator=g) for s in ((96, 3, 3), (384,), (17, 5))]
    grads = [[torch.randn(p.shape, generator=g).to(device) for p in start] for _ in range(4)]
    lrs = (0.05, 0.0499, 0.04978, 0.0496)
    ref = [p.to(device, copy=True) for p in start]
    got = [p.to(device, copy=True) for p in start]
    opt_ref = torch.optim.SGD(ref, lr=lrs[0], **RECIPES[recipe])
    opt_got = torch.optim.SGD(got, lr=lrs[0], **RECIPES[recipe])
    for k, lr in enumerate(lrs):
        for params, opt in ((ref, opt_ref), (got, opt_got)):
            for p, gr in zip(params, grads[k]):
                p.grad = gr.clone()
            for group in opt.param_groups:
                group["lr"] = lr
        opt_ref.step()
        if k == 0:
            opt_got.step()
        else:
            sgd_update(opt_got, [torch.tensor(lr, dtype=torch.float32, device=device)])
        for a, b in zip(got, ref):
            _close(a, b)
            _close(opt_got.state[a]["momentum_buffer"], opt_ref.state[b]["momentum_buffer"])
    moved = [float((a - s.to(device)).abs().max()) for a, s in zip(got, start)]
    assert min(moved) > 0


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_the_device_lr_update_follows_torch_sgd(recipe):
    _sgd_against_torch(recipe, "cpu")


class Unreached(torch.nn.Module):
    """Logits from a linear map; `spare` is a parameter the loss does not
    reach."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.lin = torch.nn.Linear(1, 3)
        self.spare = torch.nn.Parameter(torch.randn(4))

    def forward(self, x):
        return self.lin(x)


def test_an_unreached_parameter_is_decayed_without_a_clip():
    model = Unreached()
    lr, wd, mu = 0.05, 1e-4, 0.9
    opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=mu, weight_decay=wd)
    step = make_train_step(model, opt, loss_fn=dice_ce_2d_loss, clip=None)
    g = torch.Generator().manual_seed(1)
    x, y = torch.randn(2, 8, 8, 1, generator=g), torch.randint(0, 3, (2, 8, 8), generator=g)
    p0 = model.spare.detach().clone()
    out = step(x, y)
    assert out["grad_norm"] is None and torch.isfinite(out["loss"])
    assert torch.equal(model.spare.grad, torch.zeros(4))
    p1 = p0 - lr * wd * p0                        # the buffer starts at wd · p0
    torch.testing.assert_close(model.spare.detach(), p1, rtol=1e-6, atol=0)
    step(x, y)
    torch.testing.assert_close(model.spare.detach(), p1 - lr * (mu * wd * p0 + wd * p1),
                               rtol=1e-6, atol=0)


def test_the_maxvit_and_lka_spans_open_and_count_the_windows():
    B, img = 2, 64
    model = maxvit_dlka_former(9, img_size=img, device="cpu")
    x = torch.randn(B, img, img, 1, generator=torch.Generator().manual_seed(3))
    before = profiling.counts().get("dlka.maxvit.windows", 0)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        model(x)
    recs = profiling.spans()
    attn = [r for r in recs if r.name == "dlka.maxvit.attention"]
    per_image = [64] * 4 + [16] * 4 + [4] * 10 + [1] * 4      # two partitions a block
    assert [r.args["partition"] for r in attn] == ["block", "grid"] * 11
    assert [r.args["windows"] for r in attn] == [B * n for n in per_image]
    assert len([r for r in recs if r.name == "dlka.lka2d"]) == 6
    assert profiling.counts()["dlka.maxvit.windows"] - before == B * 2 * (2 * 64 + 2 * 16 + 5 * 4 + 2 * 1)


def _cell(device, overrides=None):
    bench, cell, traffic, limits, loop = run.prepare(CELL, 2147483671, device=device,
                                                     overrides=overrides)
    assert cell["config"] == "maxvit_dlka_synapse2d" and traffic["loop"] == "trainer2d"
    return limits, loop


def _checked(limits, loop) -> dict:
    got = loop.outputs()
    loop.release()
    numbers = loop.compare(got, loop.reference())
    assert set(numbers) == set(limits)
    assert all(v <= limits[k] for k, v in numbers.items()), (numbers, limits)
    return numbers


def test_the_cell_is_correct_on_the_cpu_and_gives_train_step_s():
    limits, loop = _cell("cpu", TRAIN2D_SMALL)
    loop.setup()
    loop.run_unit()
    _checked(limits, loop)
    assert loop.end_to_end(2.0, 4) == {"train_step_s": 0.5}
    bench = harness.benchmark()
    e2e = [m["name"] for m in bench["end_to_end"] if CELL in m.get("workloads", [CELL])]
    assert sorted(e2e) == ["setup_s", "train_step_s"]


# --- the card ----------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_the_device_lr_update_follows_torch_sgd_on_the_card(card, recipe):
    _sgd_against_torch(recipe, card)


@pytest.mark.cuda
def test_the_cell_replays_from_step_three_and_captures_once_over_five_lrs(card, monkeypatch):
    captures = []
    real = ts.StepGraphs._capture
    monkeypatch.setattr(ts.StepGraphs, "_capture",
                        lambda self, *a: captures.append(1) or real(self, *a))
    limits, loop = _cell(card)
    before = profiling.counts().get(GRAPHED, 0)
    loop.setup()                                  # steps 1-3: eager, capture, replay
    assert profiling.counts()[GRAPHED] - before == 2
    lrs = set()
    for _ in range(2):
        loop.run_unit()
        lrs.add(loop.trainer.optimizer.param_groups[0]["lr"])
    torch.cuda.synchronize()
    assert len(captures) == 1 and profiling.counts()[GRAPHED] - before == 4
    assert loop.trainer.step == 5 and len(lrs) == 2
    _checked(limits, loop)
