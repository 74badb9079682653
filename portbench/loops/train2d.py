"""A closed loop of 2D training steps through the program's
`training/trainer2d.Trainer2D.train_step`, on host batches as
`cli/train_synapse2d` hands them over (augmentation done ahead).

Set-up builds the model and the trainer (SGD with momentum, weight
decay, the poly LR by update count, as the CLI sets them), loads the
state made from the seed, makes a pool of `pool` distinct CT-like batches
on the card and copies them to the host, and runs the first
`checked_steps` steps on pool batches 0, 1, 2, ...: they warm every shape
up, and they are the steps the reference follows. The window goes on
through the pool in turn.

The numbers compared are `train3d`'s (`loss_gap`, `grad_gap`,
`update_gap`); the program's first gradient is read from its optimizer's
momentum after one step (momentum − wd · p₀).
"""

from __future__ import annotations

import tempfile

import torch

from portbench import data, harness
from portbench.loops import train3d


class Loop:
    unit = "step"

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.cfg
        self.t = ctx.traffic
        self.calls = 0

    def _lr(self, count: int) -> float:
        t = self.t
        frac = min(count / (t["max_epochs"] * t["iterations_per_epoch"]), 1.0)
        return t["base_lr"] * (1.0 - frac) ** 0.9

    def setup(self):
        from deformablelka_tpu_torch.training.trainer2d import Trainer2D

        c, t, cfg = self.ctx, self.t, self.cfg
        with harness.stage(c.stages, "state", c.device):
            self.state = harness.make_state(c.reference.param_shapes(cfg), c.seed, c.device)
        with harness.stage(c.stages, "build", c.device):
            self.model = c.config.build(cfg, c.device)
        self.model.load_state_dict(self.state)
        self.tmp = tempfile.TemporaryDirectory(prefix="portbench-")
        self.trainer = Trainer2D(self.model, self.tmp.name, None, base_lr=t["base_lr"],
                                 momentum=t["momentum"], weight_decay=t["weight_decay"],
                                 max_epochs=t["max_epochs"],
                                 iterations_per_epoch=t["iterations_per_epoch"])
        self.trainer.initialize()
        n, B, S = t["pool"], t["batch"], cfg["img_size"]
        images, labels = data.organs(n * B, (S, S), cfg["num_classes"], c.seed + 1, c.device)
        self.images = ((images - 0.5) / 0.5).reshape(n, B, S, S, 1)
        self.labels = labels.reshape(n, B, S, S)
        self.batches = [{"image": i.cpu().numpy(), "label": lab.int().cpu().numpy()}
                        for i, lab in zip(self.images, self.labels)]
        self.losses = []
        params = dict(self.model.named_parameters())
        opt = self.trainer.optimizer
        for k in range(t["checked_steps"]):
            self.losses.append(self.run_unit())
            if k == 0:
                self.grad1 = {name: opt.state[p].get("momentum_buffer", torch.zeros_like(p))
                              - t["weight_decay"] * self.state[name]
                              for name, p in params.items()}
        self.after = {name: p.detach().clone() for name, p in params.items()}

    def run_unit(self):
        i = self.calls % self.t["pool"]
        self.calls += 1
        return self.trainer.train_step(self.batches[i])

    @staticmethod
    def end_to_end(window_s: float, units: int) -> dict:
        return {"train2d_step_s": window_s / units}

    def release(self):
        del self.model, self.trainer
        self.tmp.cleanup()

    def outputs(self) -> dict:
        return {"losses": [float(v) for v in self.losses], "grad1": self.grad1,
                "change": {k: v - self.state[k] for k, v in self.after.items()}}

    def reference(self, tf32: bool = False) -> dict:
        """The checked steps by the plain reference (each deformable LKA
        block recomputed in the backward pass, for memory) and a plain SGD
        with momentum and weight decay at the poly LR of each step."""
        t = self.t
        with harness.tf32(tf32):
            return train3d.plain_sgd(self.ctx.reference, self.cfg, self.state, self.images,
                                     self.labels, t["checked_steps"], self._lr, t["momentum"],
                                     t["weight_decay"], nesterov=False, remat=True)

    as_answer = staticmethod(train3d.Loop.as_answer)
    compare = staticmethod(train3d.Loop.compare)

    def count(self) -> dict:
        from portbench import counts

        R, cfg, B = self.ctx.reference, self.cfg, self.t["batch"]
        S = cfg["img_size"]
        p = {k: torch.empty(s, device="meta", requires_grad=R.is_param(k))
             for k, (s, _) in R.param_shapes(cfg).items()}
        x = torch.empty(B, S, S, 1, device="meta")
        y = torch.empty(B, S, S, device="meta", dtype=torch.long)
        return counts.count_unit(lambda: R.loss(p, cfg, x, y).backward())
