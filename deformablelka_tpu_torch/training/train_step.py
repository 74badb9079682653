"""The training step: SGD with Nesterov momentum, weight decay, a global-norm
clip, and the Dice + CE loss, deep-supervised where the model returns a
list of scales.

Port of `make_sgd` and `make_train_step` in
`deformablelka_tpu/training/train_step.py`. The step reproduces
`optax.chain(clip_by_global_norm(12), add_decayed_weights(wd),
sgd(lr, momentum, nesterov=True))` step for step:

1. clip: with n = ‖g‖ over all parameters, g ← g · (12 / n) when n ≥ 12
   (optax's rule; `torch.nn.utils.clip_grad_norm_` divides by n + 1e-6,
   so it is not used);
2. g ← g + wd · p, then the Nesterov trace t ← g + μ · t (t starts at 0)
   and p ← p − lr · (g + μ · t): `torch.optim.SGD(momentum=μ,
   nesterov=True, weight_decay=wd)` does exactly this.

The trainers always clip at 12 with Nesterov on; momentum and weight
decay vary between them. A parameter that the loss does not reach gets a
zero gradient, as under `jax.grad`, so weight decay and momentum still
move it. The model's forward is already the training forward: the JAX
trainers build the model with `deterministic=True`, so dropout is the
identity and batch norm uses its running statistics
(`nn/transformer3d.py`).

With `mesh=`, `make_train_step` is the data-parallel step: each rank of
the "data" axis holds its contiguous part of the global batch
(`parallel.shard_batch`), and the step takes the gradient of the
**global-batch** loss, as the JAX step on a batch-sharded mesh does (XLA
inserts the sums there). The Synapse loss takes its Dice over the tp, fp
and fn summed over the whole batch (`batch_dice=True`), so the mean of the
ranks' own losses is not the global loss and DDP's gradient average would
be the gradient of the wrong function. Instead each rank computes its
share of the global loss (`global_dc_and_ce_loss`): the CE summed over its
voxels divided by the global voxel count, and the Dice of the tp, fp and
fn summed over the axis by a differentiable `all_reduce`, divided by the
axis's size. The shares sum to the global loss. The `all_reduce`'s
backward sums the ranks' cotangents, so each rank's gradient is the part
of the global loss's gradient that flows through its own voxels; one
`all_reduce` (SUM) of the flattened gradients then leaves exactly the
global gradient on every rank. The clip sees the same norm everywhere,
and the parameters stay bitwise equal across the ranks.

On the card, the single-rank step runs as CUDA graphs (`StepGraphs`):
the first call on a key (the shapes and dtypes of image and label, each
optimizer group's lr, momentum and weight decay) runs eagerly, which
makes SGD's momentum and warms cuDNN, cuBLAS and the hand kernels; the
second captures the phases as one graph each in one memory pool and
replays them; later calls copy their batch into the graphs' inputs and
replay. The graphs launch the same kernels in the same order as the
eager step, so the host no longer sets the pace. The data-parallel step
and the CPU step stay eager.

`make_ranger` is the JAX package's Ranger (RAdam and Lookahead); no
trainer uses it.
"""

from __future__ import annotations

import functools
import itertools

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn

from deformablelka_tpu_torch import profiling
from deformablelka_tpu_torch.ops import kernels
from deformablelka_tpu_torch.profiling import span
from deformablelka_tpu_torch.training.losses import (dc_and_ce_loss, deep_supervision_loss,
                                                     one_hot, softmax_helper)

CLIP_NORM = 12.0
GRAPHED = "dlka.step.graphed"   # the counter of steps served by replay


def make_sgd(params, lr: float, momentum: float = 0.99,
             weight_decay: float = 3e-5) -> torch.optim.SGD:
    """The Synapse trainer's optimizer after the clip (`clip_grad_norm`):
    Nesterov momentum 0.99 and weight decay 3e-5 by default."""
    return torch.optim.SGD([p for p in params if p.requires_grad], lr=lr,
                           momentum=momentum, nesterov=True,
                           weight_decay=weight_decay)


@torch.no_grad()
def clip_grad_norm(params) -> torch.Tensor:
    """Clips the gradients in place to a global norm of 12, as optax does,
    and returns their norm before the clip (a device scalar: no host
    sync). A missing gradient becomes zeros."""
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, (CLIP_NORM / norm).clamp(max=1.0))
    return norm


def model_loss(out, label, loss_fn=dc_and_ce_loss):
    """The loss of a model's output: one tensor of logits is one scale
    (`loss_fn` alone), a list of them the deep-supervision sum."""
    if torch.is_tensor(out):
        return loss_fn(out, label)
    return deep_supervision_loss(out, label, loss_fn)


def loss_of(model: torch.nn.Module, image, label):
    """The Dice + CE loss on one batch (`model_loss`: deep-supervised where
    the model returns a list): image (B, *S, Cin), label (B, *S) int; the
    model's forward and the loss in the spans `dlka.step.forward` and
    `dlka.step.loss`."""
    with span("dlka.step.forward"):
        out = model(image)
    with span("dlka.step.loss"):
        return model_loss(out, label)


def global_dc_and_ce_loss(logits, labels, group=None):
    """This rank's share of `dc_and_ce_loss` (batch Dice, background
    dropped, smooth 1e-5) over the global batch whose parts the ranks of
    `group` hold, each of the same size: the shares of all ranks sum to the
    global loss. logits (b, *S, C), labels (b, *S) int."""
    n = dist.get_world_size(group)
    C = logits.shape[-1]
    probs = softmax_helper(logits)
    y = one_hot(labels, C)
    axes = tuple(range(logits.ndim - 1))
    sums = torch.stack([(probs * y).sum(axes), (probs * (1 - y)).sum(axes),
                        ((1 - probs) * y).sum(axes)])
    tp, fp, fn = dist_nn.all_reduce(sums, group=group)
    dc = (2 * tp + 1e-5) / (2 * tp + fp + fn + 1e-5)
    dice = -dc[1:].mean()
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])
    ce = -ll.sum() / (labels.numel() * n)
    return ce + dice / n


@torch.no_grad()
def sum_gradients(params, group=None) -> None:
    """Sum every parameter's gradient over the ranks of `group`, in place,
    with one `all_reduce` of the flattened gradients. A missing gradient
    is taken as zeros."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=group)
    i = 0
    for p in params:
        p.grad.copy_(flat[i:i + p.numel()].view_as(p.grad))
        i += p.numel()


class StepGraphs:
    """The single-rank step on the card as CUDA graphs, one a phase
    (forward, loss, backward with remat's recompute, clip, update) in one
    memory pool, replayed in that order, each inside its span.

    A call on a new key runs `eager` on the capture stream and drops the
    graphs of the old key; the next call on that key captures and
    replays; later calls replay. Replays read the batch from the graphs'
    own input buffers, keep the gradients in the pool (set to None once,
    before the capture), and return fresh copies of the loss and the
    gradient norm. A replay runs no Python of the model, so it adds back
    the hand kernels' `.launches` and the counters (`profiling.count`)
    that the capture counted, files the spans the capture saw
    (`profiling.replayed`), and counts `dlka.step.graphed`."""

    def __init__(self, model, optimizer, params):
        self.model, self.optimizer, self.params = model, optimizer, params
        self.key = self.graphs = None
        self.stream = torch.cuda.Stream()

    def __call__(self, image, label, eager):
        key = (image.device, image.shape, image.dtype, label.shape, label.dtype,
               tuple((g["lr"], g["momentum"], g["weight_decay"])
                     for g in self.optimizer.param_groups))
        if key != self.key:
            self.key = self.graphs = None
            self.stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self.stream):
                out = eager(image, label)
            torch.cuda.current_stream().wait_stream(self.stream)
            self.key = key
            return out
        if self.graphs is None:
            self._capture(image, label)
        else:
            for k, n in self.launches.items():
                kernels.HAND_KERNELS[k].wrapper.launches += n
            for k, n in self.counted.items():
                profiling.count(k, n)
        self.image.copy_(image)
        self.label.copy_(label)
        for name, graph, spans in self.graphs:
            with span(name):
                graph.replay()
                profiling.replayed(spans)
        profiling.count(GRAPHED)
        return {"loss": self.loss.clone(), "grad_norm": self.grad_norm.clone()}

    def _capture(self, image, label):
        self.optimizer.zero_grad(set_to_none=True)
        self.image, self.label = image.clone(), label.clone()
        launches, counted = kernels.launch_counts(), profiling.counts()
        pool, graphs = torch.cuda.graph_pool_handle(), []

        def capture(name, fn):
            graph = torch.cuda.CUDAGraph()
            with profiling.graph_spans() as spans:
                with torch.cuda.graph(graph, pool=pool, stream=self.stream):
                    out = fn()
            graphs.append((name, graph, spans))
            return out

        out = capture("dlka.step.forward", lambda: self.model(self.image))
        loss = capture("dlka.step.loss", lambda: model_loss(out, self.label))
        del out
        capture("dlka.step.backward", loss.backward)
        self.loss = loss.detach()
        self.grad_norm = capture("dlka.step.clip", lambda: clip_grad_norm(self.params))
        capture("dlka.step.update", self.optimizer.step)
        self.launches = _gained(launches, kernels.launch_counts())
        self.counted = _gained(counted, profiling.counts())
        self.graphs = graphs


def _gained(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.SGD, mesh=None,
                    axis: str = "data"):
    """Returns step(image, label) -> {"loss", "grad_norm"}, device scalars
    of their own on every call; the step updates the model's parameters
    in place. With `mesh`, image and label are this rank's part of the
    global batch along `axis`, and the loss, the gradient and the update
    are the global batch's (the module docstring). Without, on the card,
    the step replays CUDA graphs from its second call on a key
    (`StepGraphs`). The step opens the span `dlka.step` and its phases
    `.forward`, `.loss`, `.backward` (with the mesh's gradient sum),
    `.clip` and `.update` (`profiling.span`)."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    group = None if mesh is None else mesh.group(axis)
    loss_fn = None if group is None else functools.partial(global_dc_and_ce_loss, group=group)
    calls = itertools.count()
    graphs = None
    profiling.count(GRAPHED, 0)

    def eager(image, label):
        optimizer.zero_grad()
        if group is None:
            loss = share = loss_of(model, image, label)
        else:
            with span("dlka.step.forward"):
                out = model(image)
            with span("dlka.step.loss"):
                share = model_loss(out, label, loss_fn)
                loss = share.detach().clone()
                dist.all_reduce(loss, group=group)
        with span("dlka.step.backward"):
            share.backward()
            if group is not None:
                sum_gradients(params, group)
        with span("dlka.step.clip"):
            grad_norm = clip_grad_norm(params)
        with span("dlka.step.update"):
            optimizer.step()
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    def step(image, label):
        nonlocal graphs
        with span("dlka.step", unit=True, step=next(calls)):
            if group is not None or not image.is_cuda:
                return eager(image, label)
            if graphs is None:
                graphs = StepGraphs(model, optimizer, params)
            return graphs(image, label, eager)

    return step


class Ranger(torch.optim.Optimizer):
    """RAdam and Lookahead, step for step as
    `optax.lookahead(optax.chain(add_decayed_weights(wd), radam(lr)), k, α)`
    on `LookaheadParams(fast=p, slow=p)`: per step t,

    g ← g + wd·p; m ← (1 − β1)·g + β1·m; v ← (1 − β2)·g² + β2·v;
    m̂ = m / (1 − β1^t), v̂ = v / (1 − β2^t);
    ρ = ρ∞ − 2t·β2^t / (1 − β2^t), ρ∞ = 2 / (1 − β2) − 1;
    u = −lr · (ρ ≥ 5 ? r·m̂ / (√v̂ + ε) : m̂), r = √((ρ−4)(ρ−2)ρ∞ / ((ρ∞−4)(ρ∞−2)ρ)),

    then every k-th step the slow weights s move α of the way to p + u and
    p takes their value (optax's merged form: d = p + u − s, s ← s + α·d,
    p ← p + (u − (1 − α)·d)); otherwise p ← p + u. The module's parameters
    are the fast weights. The step's scalars (β^t, ρ, r) are computed in
    float32 as optax's jitted update computes them (β^t by `pow`): ρ is a
    difference of two numbers near 2000, so its float32 rounding moves r by
    percents at the threshold.
    """

    B1, B2, EPS, THRESHOLD = 0.9, 0.999, 1e-8, 5.0   # optax.radam's

    def __init__(self, params, lr: float, weight_decay: float = 0.0,
                 sync_period: int = 6, slow_step_size: float = 0.5):
        if sync_period < 1:
            raise ValueError("sync_period must be >= 1")
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))
        self.sync_period, self.slow_step_size = sync_period, slow_step_size
        self.count, self.steps_since_sync = 0, 0

    def _scalars(self):
        """(1 − β1^t, 1 − β2^t, r or None below the threshold), float32."""
        f32 = lambda v: torch.tensor(v, dtype=torch.float32)
        t = self.count
        b2t = f32(self.B2) ** f32(t)
        ro_inf = 2.0 / (1.0 - self.B2) - 1.0
        ro = f32(ro_inf) - f32(2 * t) * b2t / (1 - b2t)
        bc1 = 1 - f32(self.B1) ** f32(t)
        r = None
        if ro.item() >= self.THRESHOLD:
            r = torch.sqrt((ro - 4.0) * (ro - 2.0) * f32(ro_inf)
                           / (f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro)).item()
        return bc1.item(), (1 - b2t).item(), r

    @torch.no_grad()
    def step(self, closure=None):
        self.count += 1
        bc1, bc2, r = self._scalars()
        sync = self.steps_since_sync == self.sync_period - 1
        alpha = self.slow_step_size
        for group in self.param_groups:
            lr, wd = group["lr"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["m"], st["v"] = torch.zeros_like(p), torch.zeros_like(p)
                    st["slow"] = p.detach().clone()
                g = p.grad + wd * p if wd else p.grad
                m, v = st["m"], st["v"]
                m.copy_((1 - self.B1) * g + self.B1 * m)
                v.copy_((1 - self.B2) * (g * g) + self.B2 * v)
                m_hat, v_hat = m / bc1, v / bc2
                u = m_hat if r is None else r * m_hat / (torch.sqrt(v_hat) + self.EPS)
                u = u * -lr
                if sync:
                    d = p + u - st["slow"]
                    st["slow"].add_(alpha * d)
                    p.add_(u - (1 - alpha) * d)
                else:
                    p.add_(u)
        self.steps_since_sync = (self.steps_since_sync + 1) % self.sync_period


def make_ranger(params, lr: float, weight_decay: float = 0.0, sync_period: int = 6,
                slow_step_size: float = 0.5) -> Ranger:
    """Ranger = RAdam + Lookahead (the JAX package's `make_ranger`; upstream's
    training/optimizer/ranger.py, unused by its trainers)."""
    return Ranger([p for p in params if p.requires_grad], lr, weight_decay, sync_period,
                  slow_step_size)
