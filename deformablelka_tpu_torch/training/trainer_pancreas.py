"""NIH-Pancreas trainer: CE + binary soft dice, SGD with step-decay LR.

Port of `deformablelka_tpu/training/trainer_pancreas.py`. Upstream's
behaviour, as the JAX package re-derived it:
  3D/pancreas_code/train_pancreas.py:106-191
    D_LKA_Net 96³ / patch (2,2,2), do_ds=False; SGD lr 0.01 momentum 0.9
    weight-decay 1e-4; loss = CE(full label) + dice_loss(softmax[:,1],
    label==1) on the labeled slice of the batch (labeled_bs); LR ×0.1 at
    every 2500 iterations; 6000 iterations total; final checkpoint
    `d_lka_former_iter_6000.pth`.
  3D/pancreas_code/utils/losses.py:5-13
    dice_loss: 1 - (2·Σ(s·t)+ε)/(Σs²+Σt²+ε), ε=1e-5.

The optimizer is the JAX package's `chain(add_decayed_weights(1e-4),
sgd(schedule, momentum 0.9, nesterov=False))`, no clip:
`torch.optim.SGD(momentum=0.9, weight_decay=1e-4)` with the LR set before
each update from the count of updates already made. A parameter the loss
does not reach gets a zero gradient, so weight decay still moves it, as
under optax. The model trains in eval mode, as the JAX trainer's is built
(`deterministic=True`). The checkpoint `d_lka_former_iter_<N>` holds
{"model": state_dict, "step": count}, which `cli/test_pancreas.py` loads.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from deformablelka_tpu_torch.training.checkpoint import CheckpointManager
from deformablelka_tpu_torch.training.losses import cross_entropy


def binary_dice_loss(score, target, smooth=1e-5):
    """losses.py:5-13 (squared-denominator soft dice on probabilities)."""
    target = target.to(score.dtype)
    intersect = (score * target).sum()
    y_sum = (target * target).sum()
    z_sum = (score * score).sum()
    return 1.0 - (2 * intersect + smooth) / (z_sum + y_sum + smooth)


def pancreas_loss(logits, labels, labeled_bs: Optional[int] = None):
    """CE + dice-on-class-1, computed on the first `labeled_bs` samples
    (train_pancreas.py:151-155; labeled_bs=None uses the whole batch)."""
    if labeled_bs is not None:
        logits = logits[:labeled_bs]
        labels = labels[:labeled_bs]
    logits = logits.float()
    ce = cross_entropy(logits, labels)
    probs = torch.softmax(logits, dim=-1)
    dl = binary_dice_loss(probs[..., 1], labels == 1)
    return ce + dl, (ce, dl)


def make_step_decay_schedule(base_lr: float = 0.01, decay_every: int = 2500,
                             factor: float = 0.1) -> Callable[[int], float]:
    """count → LR: base_lr × factor per boundary 2500, 5000, 7500 that the
    count has reached (optax's `piecewise_constant_schedule`)."""
    def schedule(count: int) -> float:
        return base_lr * factor ** min(count // decay_every, 3)
    return schedule


class TrainerPancreas:
    """Iteration-driven engine (train_pancreas.py:138-191) around a model
    already initialised and on its device."""

    def __init__(self, model, out_dir: str, base_lr: float = 0.01,
                 max_iterations: int = 6000, batch_size: int = 2,
                 labeled_bs: Optional[int] = None):
        self.model = model
        self.device = next(model.parameters()).device
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.max_iterations = max_iterations
        self.batch_size = batch_size
        self.labeled_bs = labeled_bs
        self.schedule = make_step_decay_schedule(base_lr)
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.optimizer = None
        self.step = 0  # updates made: the LR schedule's count

    def initialize(self):
        self.optimizer = torch.optim.SGD(self.params, lr=self.schedule(0),
                                         momentum=0.9, weight_decay=1e-4)
        self.step = 0

    def train_step(self, data, target) -> dict:
        """One update on a host batch (data (B, *S, 1) float32, target (B,
        *S) int): {"loss", "loss_seg", "loss_seg_dice"}, device scalars."""
        data = torch.from_numpy(np.ascontiguousarray(data, np.float32)).to(self.device)
        target = torch.from_numpy(np.ascontiguousarray(target)).to(self.device).long()
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.zero_grad()
        out = self.model(data)
        if isinstance(out, (list, tuple)):
            out = out[0]
        loss, (ce, dl) = pancreas_loss(out, target, self.labeled_bs)
        loss.backward()
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        self.step += 1
        return {"loss": loss.detach(), "loss_seg": ce.detach(),
                "loss_seg_dice": dl.detach()}

    def run_training(self, loader, log_every: int = 50,
                     callback: Optional[Callable] = None):
        if self.optimizer is None:
            self.initialize()
        it = 0
        t0 = time.time()
        while it < self.max_iterations:
            batch = loader.next_batch()
            metrics = self.train_step(batch["data"], batch["target"])
            it += 1
            if log_every and it % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                print(f"iteration: {it} Total loss : {m['loss']:.4f} "
                      f"CE loss : {m['loss_seg']:.4f} "
                      f"Dice loss : {m['loss_seg_dice']:.4f} "
                      f"({(time.time()-t0)/it:.2f}s/it)")
            if callback is not None:
                callback(it, self.model, metrics)
        self.save_checkpoint(f"d_lka_former_iter_{self.max_iterations}")
        return self.model

    def save_checkpoint(self, name: str):
        mgr = CheckpointManager(self.out_dir)
        mgr.save(name, {"model": self.model.state_dict(), "step": self.step})
        mgr.wait_until_finished()
