"""A closed loop of 3D training steps through the program's
`training/train_step.make_train_step`.

Set-up builds one model and one optimizer, loads the state made from the
seed, makes a pool of `pool` distinct CT-like batches of `batch` patches
on the card, and runs the first `checked_steps` steps on pool batches
0, 1, 2, ...: they warm every shape up, and they are the steps the
reference follows. The window goes on through the pool in turn.

What is compared, after the window (each the worst case):
- `loss_gap`: per checked step, |program's loss − reference's| over the
  reference's;
- `grad_gap`: per leaf, the gap of the first step's clipped gradient
  norms, the program's read from its optimizer's momentum after one step
  (momentum − wd · p₀), over the larger of the reference leaf's norm and
  the median leaf's;
- `update_gap`: the same for the parameters' change over the checked
  steps, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone).
"""

from __future__ import annotations

import torch

from portbench import data, harness

SMALL_GRAD = 1e-3


def plain_sgd(R, cfg, state, images, labels, steps, lr, mu, wd, nesterov, clip=None,
              remat=False):
    """`steps` steps of reference `R` from `state` on batches 0, 1, ...:
    the gradient (scaled to a global norm of `clip` where it is larger),
    g + wd·p into the momentum μ·buf + g, p − lr(step)·(g + μ·buf) with
    Nesterov, else p − lr(step)·buf. Returns the losses, the first
    gradient as the optimizer takes it, and the parameters' change.
    `remat` is the reference's (its memory)."""
    p = {k: v.clone() for k, v in state.items()}
    names = [k for k in p if R.is_param(k)]
    losses, buf, grad1 = [], {}, None
    for step in range(steps):
        q = {k: v.detach().requires_grad_(k in names) for k, v in p.items()}
        loss = R.loss(q, cfg, images[step], labels[step], remat)
        grads = torch.autograd.grad(loss, [q[k] for k in names])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            scale = 1.0
            if clip is not None:
                norm = float(torch.sqrt(sum(g.double().square().sum() for g in grads)))
                scale = min(1.0, clip / norm)
            grads = [g * scale for g in grads]
            for k, g in zip(names, grads):
                d = g + wd * p[k]
                buf[k] = d if step == 0 else mu * buf[k] + d
                p[k] = p[k] - lr(step) * (d + mu * buf[k] if nesterov else buf[k])
            if step == 0:
                grad1 = dict(zip(names, grads))
        del q, loss, grads
    return {"losses": losses, "grad1": grad1, "change": {k: p[k] - state[k] for k in names}}


class Loop:
    unit = "step"

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = dict(ctx.cfg, do_ds=True)
        self.t = ctx.traffic
        self.calls = 0

    def setup(self):
        from deformablelka_tpu_torch.training.train_step import make_sgd, make_train_step

        c, t, cfg = self.ctx, self.t, self.cfg
        with harness.stage(c.stages, "state", c.device):
            self.state = harness.make_state(c.reference.param_shapes(cfg), c.seed, c.device)
        with harness.stage(c.stages, "build", c.device):
            self.model = c.config.build(cfg, c.device, remat=t["remat"])
        self.model.load_state_dict(self.state)
        self.opt = make_sgd(self.model.parameters(), t["lr"], t["momentum"], t["weight_decay"])
        self.step = make_train_step(self.model, self.opt)
        n, B, S = t["pool"], t["batch"], tuple(cfg["img_size"])
        images, labels = data.organs(n * B, S, cfg["num_classes"], c.seed + 1, c.device)
        self.images = data.zscore(images).reshape(n, B, *S, 1)
        self.labels = labels.reshape(n, B, *S)
        self.losses = []
        params = dict(self.model.named_parameters())
        for k in range(t["checked_steps"]):
            self.losses.append(self.run_unit())
            if k == 0:
                self.grad1 = {name: self.opt.state[p].get("momentum_buffer", torch.zeros_like(p))
                              - t["weight_decay"] * self.state[name]
                              for name, p in params.items()}
        self.after = {name: p.detach().clone() for name, p in params.items()}

    def run_unit(self):
        i = self.calls % self.t["pool"]
        self.calls += 1
        return self.step(self.images[i], self.labels[i])["loss"]

    @staticmethod
    def end_to_end(window_s: float, units: int) -> dict:
        return {"train_step_s": window_s / units}

    def release(self):
        del self.model, self.opt, self.step

    def outputs(self) -> dict:
        return {"losses": [float(v) for v in self.losses], "grad1": self.grad1,
                "change": {k: v - self.state[k] for k, v in self.after.items()}}

    def reference(self, tf32: bool = False) -> dict:
        """The checked steps by the plain reference and a plain SGD: clip at
        12 by the global norm, weight decay, Nesterov momentum."""
        t = self.t
        with harness.tf32(tf32):
            return plain_sgd(self.ctx.reference, self.cfg, self.state, self.images,
                             self.labels, t["checked_steps"], lambda step: t["lr"],
                             t["momentum"], t["weight_decay"], nesterov=True, clip=t["clip"])

    @staticmethod
    def as_answer(ref: dict) -> dict:
        return ref

    @staticmethod
    def compare(got: dict, ref: dict) -> dict:
        loss_gap = max(harness.rel_gap(a, b) for a, b in zip(got["losses"], ref["losses"]))
        grad_gap = harness.leaf_gap(got["grad1"], ref["grad1"])
        norms = {k: float(torch.linalg.vector_norm(v)) for k, v in ref["grad1"].items()}
        med = sorted(norms.values())[len(norms) // 2]
        keep = [k for k, n in norms.items() if n >= SMALL_GRAD * med]
        update_gap = harness.leaf_gap(got["change"], ref["change"], keep)
        return {"loss_gap": loss_gap, "grad_gap": grad_gap, "update_gap": update_gap}

    def count(self) -> dict:
        from portbench import counts

        R, cfg, B = self.ctx.reference, self.cfg, self.t["batch"]
        p = {k: torch.empty(s, device="meta", requires_grad=R.is_param(k))
             for k, (s, _) in R.param_shapes(cfg).items()}
        x = torch.empty(B, *cfg["img_size"], 1, device="meta")
        y = torch.empty(B, *cfg["img_size"], device="meta", dtype=torch.long)
        return counts.count_unit(lambda: R.loss(p, cfg, x, y).backward())
