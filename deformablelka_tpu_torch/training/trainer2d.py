"""2D trainers: Synapse slices (`Trainer2D`) and skin lesions (`TrainerSkin`).

Port of `deformablelka_tpu/training/trainer2d.py`. Upstream's parity
targets, as the JAX package re-derived them:
  2D/trainer_MaxViT_deform_LKA.py:72-213 — SGD momentum 0.9 wd 1e-4
  (:114), loss 0.4·CE + 0.6·Dice (:137-139), per-ITERATION poly LR
  `base_lr·(1-it/max_it)^0.9` (:145-147), batch 24, max_epochs 400, eval
  every `eval_interval` epochs after half the run (:179-191), the best
  model's weights at the end (:180-183).
  2D/skin_code/train_skin_2017.py:102-152 — BCE-with-logits, SGD momentum
  0.9 wd 1e-4, ReduceLROnPlateau(0.5, patience 10) on the validation
  loss, a checkpoint at each new best validation loss.

The optimizer is the JAX package's `chain(add_decayed_weights(1e-4),
sgd(lr, momentum 0.9))`: `torch.optim.SGD(momentum=0.9, weight_decay=1e-4)`,
the momentum buffer holding no LR. So:
- `Trainer2D` sets the LR before each update from the count of updates
  already made, n: `base_lr·(1 − n/max_it)^0.9`, as optax's schedule reads
  its count;
- `TrainerSkin` sets base_lr × the plateau scale before each update,
  which equals the JAX step's scaling of its final update.
A parameter the loss does not reach gets a zero gradient, so weight decay
still moves it, as under optax.

`Trainer2D` steps through the port's training step
(`training/train_step.make_train_step` with its loss and no clip): on the
card its second step captures CUDA graphs and later steps replay them,
the poly LR read from the card, so a new LR each update captures once.
Its host batches go up through pinned buffers with `non_blocking=True`
(`_to_device`), and `run_training` fetches an epoch's losses once, at
the epoch's end. `TrainerSkin` keeps an eager step of its own.

The trainers take a model already initialised and on its device (the
card, or the CPU where the caller built it there) and keep it in eval
mode: the JAX 2D models are built with `deterministic=True`, and the JAX
MaxViT's batch norm always reads its running statistics, so no statistic
is updated and dropout is off. Host batches are moved to the model's
device. Checkpoints go through `training/checkpoint.py`: `Trainer2D`
writes `epoch_<N>` ({"model", "optimizer", "step"}) where it evaluates and
`best_model` ({"model": state_dict}) at the end, under `<output>/ckpt`;
`TrainerSkin` writes `best_model` ({"model": state_dict}, bookkeeping
{"val_loss", "epoch"}) in its output folder.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from deformablelka_tpu_torch.training.checkpoint import CheckpointManager
from deformablelka_tpu_torch.training.losses import dice_ce_2d_loss
from deformablelka_tpu_torch.training.train_step import make_train_step, zero_missing_grads

log = logging.getLogger("deformablelka_tpu_torch.trainer2d")


def bce_with_logits(logits, labels):
    """Binary path for the skin pipeline; logits (B, H, W, 1), labels
    (B, H, W) ∈ {0,1}."""
    l = logits[..., 0].float()
    y = labels.float()
    return (l.clamp(min=0) - l * y + torch.log1p(torch.exp(-l.abs()))).mean()


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


_STAGING: dict = {}   # (shape, dtype) -> two [pinned buffer, event of its last upload]


def _to_device(array, device, dtype=torch.float32) -> torch.Tensor:
    """A host array on `device` as `dtype`. To the card it goes through
    one of two pinned buffers of its shape and dtype, taken in turn, and
    `non_blocking=True`: the host waits only for the upload that last
    read the buffer (its event), two uploads of that shape back."""
    host = torch.from_numpy(np.ascontiguousarray(array))
    if torch.device(device).type != "cuda":
        return host.to(device=device, dtype=dtype)
    ring = _STAGING.setdefault((host.shape, dtype), [])
    if len(ring) < 2:
        ring.append([torch.empty(host.shape, dtype=dtype, pin_memory=True), None])
    slot = ring.pop(0)
    ring.append(slot)
    if slot[1] is not None:
        slot[1].synchronize()
    slot[0].copy_(host)
    out = slot[0].to(device, non_blocking=True)
    slot[1] = torch.cuda.Event()
    slot[1].record()
    return out


class Trainer2D:
    def __init__(self, model, output_folder, train_gen,
                 base_lr=0.05, momentum=0.9, weight_decay=1e-4,
                 max_epochs=400, iterations_per_epoch=None,
                 loss_fn: Callable = dice_ce_2d_loss,
                 eval_hook: Optional[Callable] = None,
                 eval_interval: int = 20,
                 tensorboard_dir: Optional[str] = None):
        self.model = model.eval()
        self.device = _device_of(model)
        self.output_folder = Path(output_folder)
        self.output_folder.mkdir(parents=True, exist_ok=True)
        self.train_gen = train_gen
        self.base_lr = base_lr
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.max_epochs = max_epochs
        self.iterations_per_epoch = iterations_per_epoch
        self.loss_fn = loss_fn
        self.eval_hook = eval_hook
        self.eval_interval = eval_interval
        self.ckpt = CheckpointManager(self.output_folder / "ckpt")
        self.epoch = 0
        self.losses = []
        self.eval_results = []  # (epoch, what the eval hook returned)
        self.epoch_times = []   # seconds of each epoch's training steps
        self.optimizer = None
        self.step = 0  # updates made: the LR schedule's count
        # tensorboardX scalars + image panels
        # (trainer_MaxViT_deform_LKA.py:116,150-174)
        self._tb = None
        if tensorboard_dir is not None:
            try:
                from tensorboardX import SummaryWriter
                self._tb = SummaryWriter(str(tensorboard_dir))
            except ImportError:
                log.warning("tensorboardX unavailable; TB logging off")

    def _max_iterations(self):
        return self.max_epochs * self.iterations_per_epoch

    def lr(self, count: int) -> float:
        """The poly LR after `count` updates."""
        frac = min(count / self._max_iterations(), 1.0)
        return self.base_lr * (1.0 - frac) ** 0.9

    def initialize(self, example_batch=None):
        """A fresh optimizer (no momentum yet), the training step on it
        (the trainer's loss, no clip) and the count at 0. The batch is the
        JAX trainer's init input; the port's model is built already."""
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer = torch.optim.SGD(self.params, lr=self.lr(0),
                                         momentum=self.momentum,
                                         weight_decay=self.weight_decay)
        self._step_fn = make_train_step(self.model, self.optimizer, loss_fn=self.loss_fn,
                                        clip=None)
        self.step = 0

    def train_step(self, batch) -> torch.Tensor:
        """One update on a host batch (image (B, H, W, Cin) float32, label
        (B, H, W) int) at the poly LR of the updates made; returns the
        loss, a device scalar."""
        image = _to_device(batch["image"], self.device)
        label = _to_device(batch["label"], self.device, torch.long)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr(self.step)
        loss = self._step_fn(image, label)["loss"]
        self.step += 1
        if self._tb is not None:
            self._log_tb(float(loss), image, label)
        return loss

    def _state(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(), "step": self.step}

    def run_training(self):
        if self.optimizer is None:
            first = self.train_gen.next()
            if self.iterations_per_epoch is None:
                self.iterations_per_epoch = getattr(
                    self.train_gen, "num_batches", 100)
            self.initialize(first)
        while self.epoch < self.max_epochs:
            t0 = time.time()
            ep_losses = [self.train_step(self.train_gen.next())
                         for _ in range(self.iterations_per_epoch)]
            self.losses.append(float(np.mean(torch.stack(ep_losses).tolist())))
            self.epoch_times.append(time.time() - t0)
            self.epoch += 1
            log.info("epoch %d loss %.4f (%.1fs)", self.epoch,
                     self.losses[-1], time.time() - t0)
            if (self.eval_hook is not None
                    and self.epoch > self.max_epochs // 2
                    and self.epoch % self.eval_interval == 0):
                self.eval_results.append((self.epoch, self.eval_hook(self)))
                self.ckpt.save(f"epoch_{self.epoch}", self._state(),
                               {"epoch": self.epoch})
        # the inference checkpoint (the .pth state_dict,
        # trainer_MaxViT_deform_LKA.py:180-183): the weights only
        self.ckpt.save("best_model", {"model": self.model.state_dict()},
                       {"epoch": self.epoch})
        self.ckpt.wait_until_finished()
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()

    @torch.no_grad()
    def _log_tb(self, loss, image, label):
        it = self.step
        frac = min(it / self._max_iterations(), 1.0)
        self._tb.add_scalar("info/lr", self.base_lr * (1 - frac) ** 0.9, it)
        self._tb.add_scalar("info/total_loss", loss, it)
        if it % 20 == 0:
            img = image[0].cpu().numpy()
            img = (img - img.min()) / max(float(img.max() - img.min()), 1e-8)
            self._tb.add_image("train/Image", img.mean(-1, keepdims=True), it,
                               dataformats="HWC")
            pred = self.model(image[:1]).argmax(-1)[0].cpu().numpy()
            self._tb.add_image("train/Prediction",
                               (pred[..., None] * 50).astype(np.uint8), it,
                               dataformats="HWC")
            gt = label[0].cpu().numpy()
            self._tb.add_image("train/GroundTruth",
                               (gt[..., None] * 50).astype(np.uint8), it,
                               dataformats="HWC")


class ReduceLROnPlateau:
    """torch-semantics LR plateau scheduler (train_skin_2017.py:105:
    mode 'min', factor 0.5, patience 10), as a multiplier of the LR that
    the trainer applies at each update."""

    def __init__(self, factor: float = 0.5, patience: int = 10,
                 threshold: float = 1e-4):
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.best = float("inf")
        self.num_bad = 0
        self.scale = 1.0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.scale *= self.factor
                self.num_bad = 0
        return self.scale


class TrainerSkin:
    """Skin-lesion binary trainer (train_skin_2017.py:102-152):
    BCE-with-logits, SGD momentum 0.9 wd 1e-4, ReduceLROnPlateau on the
    validation loss, a checkpoint at each new best validation loss
    ({'model_weights', 'val_loss'} upstream)."""

    def __init__(self, model, output_folder, base_lr: float = 1e-3,
                 max_epochs: int = 100):
        self.model = model.eval()
        self.device = _device_of(model)
        self.output_folder = Path(output_folder)
        self.output_folder.mkdir(parents=True, exist_ok=True)
        self.base_lr = base_lr
        self.max_epochs = max_epochs
        self.ckpt = CheckpointManager(self.output_folder)
        self.scheduler = ReduceLROnPlateau()
        self.best_val_loss = float("inf")
        self.optimizer = None
        self.epoch_times = []  # seconds of each epoch: training, validation, checkpoint

    def initialize(self, example_batch=None):
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer = torch.optim.SGD(self.params, lr=self.base_lr,
                                         momentum=0.9, weight_decay=1e-4)

    def train_step(self, image, mask, lr_scale: float) -> torch.Tensor:
        """One update at LR base_lr · lr_scale on a host batch (image (B,
        H, W, 3), mask (B, H, W, 1)); returns the loss, a device scalar."""
        for group in self.optimizer.param_groups:
            group["lr"] = self.base_lr * lr_scale
        self.optimizer.zero_grad()
        loss = bce_with_logits(self.model(_to_device(image, self.device)),
                               _to_device(mask, self.device)[..., 0])
        loss.backward()
        zero_missing_grads(self.params)
        self.optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def eval_loss(self, image, mask) -> torch.Tensor:
        return bce_with_logits(self.model(_to_device(image, self.device)),
                               _to_device(mask, self.device)[..., 0])

    def run_training(self, train_loader, val_loader, log_every: int = 20):
        lr_scale = 1.0
        for ep in range(self.max_epochs):
            t0 = time.time()
            ep_loss, n = 0.0, 0
            for batch in train_loader.epoch():
                if self.optimizer is None:
                    self.initialize(batch)
                ep_loss += float(self.train_step(batch["image"], batch["mask"],
                                                 lr_scale))
                n += 1
                if log_every and n % log_every == 0:
                    log.info("epoch %d iter %d loss %.4f", ep + 1, n,
                             ep_loss / n)
            val_loss, vn = 0.0, 0
            for batch in val_loader.epoch():
                val_loss += float(self.eval_loss(batch["image"], batch["mask"]))
                vn += 1
            mean_val = val_loss / max(vn, 1)
            log.info("epoch %d train %.4f val %.4f", ep + 1,
                     ep_loss / max(n, 1), mean_val)
            if mean_val < self.best_val_loss:
                self.best_val_loss = mean_val
                self.ckpt.save("best_model", {"model": self.model.state_dict()},
                               {"val_loss": mean_val, "epoch": ep + 1})
            lr_scale = self.scheduler.step(mean_val)
            self.epoch_times.append(time.time() - t0)
        self.ckpt.wait_until_finished()
        return self.model
