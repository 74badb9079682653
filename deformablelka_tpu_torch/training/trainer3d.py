"""The 3D trainer: nnUNet's epoch engine around the deep-supervision step.

Port of `deformablelka_tpu/training/trainer3d.py`. Upstream's parity
targets, as the JAX package re-derived them:
  d_lka_former_trainer_synapse.py:40-491 — 1000 epochs × 250 train
  iterations + 50 val iterations, SGD nesterov momentum 0.99 lr 1e-2
  wd 3e-5, poly LR (:437-452), grad-clip 12 (:291-301), deep
  supervision `MultipleOutputLoss2` (:92-108), online eval via global
  tp/fp/fn dice (Trainer_synapse.py:694-743), checkpoint model_best/
  model_latest/model_final (network_trainer_synapse.py:283-348), EMA
  val-loss bookkeeping, divergence fallback at epoch 100 (momentum
  0.99→0.95 if dice==0, :462-471).

As in the JAX package, and unlike upstream:
- the LR is a function of the count of updates made (`step`): epoch =
  step // num_batches_per_epoch, poly over that (`_lr_schedule`);
  `_set_lr` only gives the LR the log shows. Validation makes no update,
  so it moves neither the count nor the parameters;
- the fallback rebuilds the optimizer: fresh momentum buffers and the
  count back at 0, so the LR starts again at `initial_lr`;
- the model trains in eval mode (the JAX trainers build it with
  `deterministic=True`: batch norm on its running statistics, no
  dropout).

The trainer takes a model already initialised and on its device (the
card, or the CPU where the caller built it there); batches come from
host generators with `.next()` (`data/augment.ThreadedAugmenter`), are
moved to the model's device, their targets to int64. A checkpoint holds
{"model": state_dict, "optimizer": state_dict, "step": count} and the
bookkeeping as JSON (`training/checkpoint.py`).
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

import numpy as np
import torch

from deformablelka_tpu_torch.training.checkpoint import (
    CheckpointManager, should_save_scheduled)
from deformablelka_tpu_torch.training.losses import (
    dc_and_ce_loss, deep_supervision_weights, poly_lr)
from deformablelka_tpu_torch.training.train_step import clip_grad_norm, make_sgd

log = logging.getLogger("deformablelka_tpu_torch.trainer3d")


def ds_loss(out, target, weights):
    """Σ_i w_i · (Dice + CE)(out_i, target_i) over the model's outputs and
    the precomputed per-scale label maps (one map is used for every
    output)."""
    if not isinstance(out, (list, tuple)):
        out = [out]
    if not isinstance(target, (list, tuple)):
        target = [target] * len(out)
    loss = 0.0
    for w, o, t in zip(weights, out, target):
        loss = loss + float(w) * dc_and_ce_loss(o, t)
    return loss


def _head(out):
    return out[0] if isinstance(out, (list, tuple)) else out


@torch.no_grad()
def online_counts(logits, target):
    """tp, fp, fn per class of argmax(logits) against target, background
    dropped, as float32 device tensors (no host sync)."""
    C = logits.shape[-1]
    pred = logits.argmax(-1).flatten()
    tgt = target.flatten().long()
    tp = torch.bincount(torch.where(pred == tgt, pred, C), minlength=C + 1)[:C]
    fp = torch.bincount(pred, minlength=C)[:C] - tp
    fn = torch.bincount(tgt, minlength=C)[:C] - tp
    return tp[1:].float(), fp[1:].float(), fn[1:].float()


def _metrics(loss, logits, batch):
    target = batch["target"]
    tgt = target[0] if isinstance(target, (list, tuple)) else target
    tp, fp, fn = online_counts(logits, tgt)
    return {"loss": loss.detach(), "tp": tp, "fp": fp, "fn": fn}


def make_ds_train_step(model, optimizer, n_ds_outputs: int = 3):
    """Returns step(batch, lr) -> {"loss", "tp", "fp", "fn"} (device
    tensors): the deep-supervision Dice + CE loss over the batch's
    precomputed targets, the clip at 12, then `optimizer` (weight decay
    and Nesterov momentum, `make_sgd`) at learning rate `lr`; the model's
    parameters are updated in place. tp/fp/fn are the online-eval counts
    of the logits before the update."""
    w = deep_supervision_weights(n_ds_outputs)
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(batch, lr: float):
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.zero_grad()
        out = model(batch["data"])
        loss = ds_loss(out, batch["target"], w)
        loss.backward()
        clip_grad_norm(params)
        optimizer.step()
        return _metrics(loss, _head(out), batch)

    return step


class Trainer3D:
    def __init__(self, model, output_folder, train_gen, val_gen=None,
                 initial_lr=1e-2, momentum=0.99, weight_decay=3e-5,
                 max_num_epochs=1000, num_batches_per_epoch=250,
                 num_val_batches_per_epoch=50, n_ds_outputs=3,
                 save_every=50, tensorboard_dir=None,
                 save_intermediate_checkpoints=True,
                 save_latest_only=False, checkpoint_warmup_epochs=400,
                 max_scheduled_keep=5):
        self.model = model
        self.device = next(model.parameters()).device
        self.output_folder = Path(output_folder)
        self.output_folder.mkdir(parents=True, exist_ok=True)
        self.train_gen = train_gen
        self.val_gen = val_gen
        self.initial_lr = initial_lr
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.max_num_epochs = max_num_epochs
        self.num_batches_per_epoch = num_batches_per_epoch
        self.num_val_batches_per_epoch = num_val_batches_per_epoch
        self.n_ds_outputs = n_ds_outputs
        self.save_every = save_every
        self._tb = None
        if tensorboard_dir is not None:  # tensorboardX epoch scalars
            try:
                from tensorboardX import SummaryWriter
                self._tb = SummaryWriter(str(tensorboard_dir))
            except ImportError:
                log.warning("tensorboardX unavailable; TB logging off")
        self.epoch = 0
        self.all_tr_losses = []
        self.all_val_losses = []
        self.all_val_eval_metrics = []
        self.best_val_eval = -np.inf
        self.save_intermediate_checkpoints = save_intermediate_checkpoints
        self.save_latest_only = save_latest_only
        self.checkpoint_warmup_epochs = checkpoint_warmup_epochs
        self.ckpt = CheckpointManager(
            self.output_folder / "ckpt",
            max_scheduled_keep=max_scheduled_keep)
        self.optimizer = None
        self.step = 0  # updates made: the LR schedule's count
        self._step_fn = None

    # -- setup ----------------------------------------------------------
    def _lr_schedule(self, count: int) -> float:
        """Per-epoch poly LR as a function of the update count (epoch =
        count // num_batches_per_epoch)."""
        epoch = count // self.num_batches_per_epoch
        frac = min(epoch / self.max_num_epochs, 1.0)
        return self.initial_lr * (1.0 - frac) ** 0.9

    def initialize(self):
        """A fresh optimizer (momentum buffers empty) and the count at 0;
        the model's weights are left as they are."""
        self.optimizer = make_sgd(self.model.parameters(), self._lr_schedule(0),
                                  momentum=self.momentum,
                                  weight_decay=self.weight_decay)
        self.step = 0
        self._step_fn = make_ds_train_step(self.model, self.optimizer,
                                           self.n_ds_outputs)
        n = sum(p.numel() for p in self.model.parameters())
        log.info("initialized model with %.2fM params", n / 1e6)

    def _set_lr(self):
        return poly_lr(self.epoch, self.max_num_epochs, self.initial_lr,
                       0.9)

    # -- loops ----------------------------------------------------------
    def _to_device_batch(self, batch):
        def target(t):
            return torch.from_numpy(np.ascontiguousarray(t)).to(self.device).long()

        tgt = batch["target"]
        tgt = ([target(t) for t in tgt] if isinstance(tgt, (list, tuple))
               else target(tgt))
        data = np.ascontiguousarray(batch["data"], dtype=np.float32)
        return {"data": torch.from_numpy(data).to(self.device), "target": tgt}

    def train_batch(self, batch) -> float:
        """One update on a host batch; its loss (a host sync)."""
        metrics = self._step_fn(self._to_device_batch(batch),
                                self._lr_schedule(self.step))
        self.step += 1
        return float(metrics["loss"])

    @torch.no_grad()
    def evaluate(self, batch) -> dict:
        """The step's loss and tp/fp/fn on a host batch, with no update."""
        b = self._to_device_batch(batch)
        out = self.model(b["data"])
        loss = ds_loss(out, b["target"],
                       deep_supervision_weights(self.n_ds_outputs))
        return _metrics(loss, _head(out), b)

    def run_training(self):
        if self._step_fn is None:
            self.initialize()
        while self.epoch < self.max_num_epochs:
            self.run_epoch()
        self.save_checkpoint("model_final_checkpoint")
        self.ckpt.wait_until_finished()
        self.plot_progress()
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()

    def run_epoch(self):
        t0 = time.time()
        lr = self._set_lr()
        tr_losses = [self.train_batch(self.train_gen.next())
                     for _ in range(self.num_batches_per_epoch)]
        self.all_tr_losses.append(float(np.mean(tr_losses)))

        if self.val_gen is not None:
            val_losses, tps, fps, fns = [], [], [], []
            for _ in range(self.num_val_batches_per_epoch):
                metrics = self.evaluate(self.val_gen.next())
                val_losses.append(float(metrics["loss"]))
                tps.append(metrics["tp"].cpu().numpy())
                fps.append(metrics["fp"].cpu().numpy())
                fns.append(metrics["fn"].cpu().numpy())
            self.all_val_losses.append(float(np.mean(val_losses)))
            tp = np.sum(tps, 0)
            fp = np.sum(fps, 0)
            fn = np.sum(fns, 0)
            dice = 2 * tp / np.maximum(2 * tp + fp + fn, 1e-8)
            global_dice = float(np.mean(dice))
            self.all_val_eval_metrics.append(global_dice)
            if global_dice > self.best_val_eval:
                self.best_val_eval = global_dice
                self.save_checkpoint("model_best")

        self.epoch += 1
        if self.epoch % self.save_every == 0:
            # upstream additionally writes an immutable model_ep_%03d
            # once past the warmup (network_trainer_synapse.py:546-556);
            # model_latest every save_every is kept unconditionally so
            # --continue_training works from any point
            if (self.save_intermediate_checkpoints
                    and not self.save_latest_only
                    and should_save_scheduled(
                        self.epoch, self.save_every,
                        self.checkpoint_warmup_epochs)):
                self.ckpt.save_scheduled(self.epoch, self._state(),
                                         self._bookkeeping())
            self.save_checkpoint("model_latest")
            self.plot_progress()
        self.print_to_log_file(
            f"epoch {self.epoch} lr {lr:.5f} "
            f"tr_loss {self.all_tr_losses[-1]:.4f} "
            f"({time.time() - t0:.1f}s)")
        if self._tb is not None:
            self._tb.add_scalar("info/lr", float(lr), self.epoch)
            self._tb.add_scalar("loss/train",
                                self.all_tr_losses[-1], self.epoch)
            if self.all_val_losses:
                self._tb.add_scalar("loss/val",
                                    self.all_val_losses[-1],
                                    self.epoch)
            if self.all_val_eval_metrics:
                self._tb.add_scalar("eval/global_dice",
                                    self.all_val_eval_metrics[-1],
                                    self.epoch)
        self._maybe_fallback()

    # -- observability (network_trainer_synapse.py:188-281) ---------------
    def print_to_log_file(self, *args):
        """Timestamped training log file + stdout
        (network_trainer_synapse.py:249-281)."""
        import datetime
        msg = " ".join(str(a) for a in args)
        stamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S.%f")
        line = f"{stamp}: {msg}"
        log.info(msg)
        logfile = self.output_folder / "training_log.txt"
        for _ in range(5):  # retry like upstream
            try:
                with open(logfile, "a") as f:
                    f.write(line + "\n")
                break
            except OSError:
                time.sleep(0.1)

    def plot_progress(self):
        """progress.png: train/val losses + online eval metric
        (network_trainer_synapse.py:188-247); skipped without matplotlib."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        fig, ax = plt.subplots(figsize=(10, 6))
        xs = np.arange(1, len(self.all_tr_losses) + 1)
        ax.plot(xs, self.all_tr_losses, color="b", ls="-",
                label="loss_tr")
        if self.all_val_losses:
            ax.plot(np.arange(1, len(self.all_val_losses) + 1),
                    self.all_val_losses, color="r", ls="-", label="loss_val")
        ax.set_xlabel("epoch")
        ax.set_ylabel("loss")
        ax.legend(loc="upper left")
        if self.all_val_eval_metrics:
            ax2 = ax.twinx()
            ax2.plot(np.arange(1, len(self.all_val_eval_metrics) + 1),
                     self.all_val_eval_metrics, color="g", ls="--",
                     label="evaluation metric")
            ax2.set_ylabel("dice")
            ax2.legend(loc="lower right")
        fig.savefig(self.output_folder / "progress.png")
        plt.close(fig)

    # -- LR range test ----------------------------------------------------
    def find_lr(self, num_iters=1000, init_value=1e-6, final_value=10.0,
                beta=0.98, plot_file=None):
        """LR range sweep (network_trainer_synapse.py:719-765): grow LR
        exponentially each iteration, track the smoothed loss, stop when
        it exceeds 4× the best. Returns (log10_lrs, smoothed_losses).

        The sweep runs its own Nesterov SGD (no clip, no weight decay) on
        the model and puts the model's weights back at the end."""
        import math

        if self._step_fn is None:
            self.initialize()
        saved = {k: v.clone() for k, v in self.model.state_dict().items()}
        sgd = torch.optim.SGD([p for p in self.model.parameters() if p.requires_grad],
                              lr=init_value, momentum=self.momentum, nesterov=True)
        mult = (final_value / init_value) ** (1.0 / num_iters)
        lr = init_value
        avg_loss, best_loss = 0.0, 0.0
        losses, log_lrs = [], []
        try:
            for it in range(1, num_iters + 1):
                batch = self._to_device_batch(self.train_gen.next())
                for group in sgd.param_groups:
                    group["lr"] = lr
                sgd.zero_grad()
                out = self.model(batch["data"])
                n_out = len(out) if isinstance(out, (list, tuple)) else 1
                loss = ds_loss(out, batch["target"], deep_supervision_weights(n_out))
                loss.backward()
                sgd.step()
                loss = float(loss.detach()) + 1.0
                avg_loss = beta * avg_loss + (1 - beta) * loss
                smoothed = avg_loss / (1 - beta ** it)
                if it > 1 and smoothed > 4 * best_loss:
                    break
                if smoothed < best_loss or it == 1:
                    best_loss = smoothed
                losses.append(smoothed)
                log_lrs.append(math.log10(lr))
                lr *= mult
        finally:
            self.model.load_state_dict(saved)
        if plot_file is not None:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            fig = plt.figure()
            plt.xscale("log")
            plt.plot([10 ** l for l in log_lrs[10:-5]], losses[10:-5])
            plt.savefig(plot_file)
            plt.close(fig)
        return log_lrs, losses

    def _maybe_fallback(self):
        """Divergence heuristic (d_lka_former_trainer_synapse.py:462-471):
        at epoch 100, if online dice is still 0, drop momentum to 0.95 and
        start a fresh optimizer (its count, hence the LR schedule, from 0)."""
        if (self.epoch == 100 and self.all_val_eval_metrics
                and np.mean(self.all_val_eval_metrics[-5:]) == 0):
            log.warning("dice still 0 at epoch 100 — momentum 0.99→0.95")
            self.momentum = 0.95
            self.initialize()

    # -- checkpointing --------------------------------------------------
    def _bookkeeping(self) -> dict:
        return {"epoch": self.epoch,
                "all_tr_losses": self.all_tr_losses,
                "all_val_losses": self.all_val_losses,
                "all_val_eval_metrics": self.all_val_eval_metrics,
                "best_val_eval": self.best_val_eval}

    def _state(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(), "step": self.step}

    def save_checkpoint(self, name: str):
        self.ckpt.save(name, self._state(), self._bookkeeping())

    def load_checkpoint(self, name: str = "model_latest"):
        if self.optimizer is None:
            self.initialize()
        state, book = self.ckpt.load(name, map_location=self.device)
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        if book:
            self.epoch = int(book["epoch"])
            self.all_tr_losses = list(book["all_tr_losses"])
            self.all_val_losses = list(book["all_val_losses"])
            self.all_val_eval_metrics = list(book["all_val_eval_metrics"])
            self.best_val_eval = float(book["best_val_eval"])
