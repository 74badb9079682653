"""The port's 2D training paths, driven through their entry points.

- **Synapse** (`cli/train_synapse2d.py`): seeded synthetic Synapse-like
  slices (`write_slices`: `<slice>.npz` with `image` (512, 512) float32 in
  [0, 1] and `label` (512, 512) with 9 labels, listed in `train.txt`)
  train the MaxViT D-LKA Net (9 classes, 224², from the CLI's seed) at
  batch 24 for 2 epochs of 2 batches; the eval hook runs at epoch 2 on two
  40×512×512 volumes held in memory (`volumes`), then the CLI writes
  `best_model`; `cli/test_synapse2d.evaluate_volumes` predicts the same
  volumes from that checkpoint.
- **Skin** (`cli/train_skin.py`): `data_/mask_{train,val,test}.npy` of
  224² RGB images (`write_skin`: 32 / 8 / 8 of them) train the flagship
  with one output class at batch 16 for 2 epochs, then the test split is
  evaluated from `best_model`.

    python -m deformablelka_tpu_torch.trainer2d_path [--device cpu]

runs both in a temporary directory and prints s/step (the median after
the first), the host seconds of loading and augmenting a batch, s/epoch,
the checkpoint writes, the eval hook's Dice, the test volumes' Dice and
the skin metrics, and the kernel launches per step. `Recorder` times the
pieces; `chip_smoke.py` (phases 20-21) drives the same paths on the card
and holds them against the plain versions.
"""

from __future__ import annotations

import argparse
import contextlib
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from unittest import mock

import numpy as np
import torch
from scipy.ndimage import gaussian_filter

from deformablelka_tpu_torch import case_path
from deformablelka_tpu_torch.cli import train_skin, train_synapse2d
from deformablelka_tpu_torch.data.synapse2d import SynapseLoader2D, normalize_05
from deformablelka_tpu_torch.models.maxvit_dlka import maxvit_dlka_former, maxvit_lka_former
from deformablelka_tpu_torch.ops import kernels
from deformablelka_tpu_torch.profiling import timed
from deformablelka_tpu_torch.training.checkpoint import CheckpointManager
from deformablelka_tpu_torch.training.trainer2d import Trainer2D, TrainerSkin

NUM_CLASSES = 9
SEED = 1234  # the CLIs' default
IMG = 224
SLICE = 512
BATCH = 24
SKIN_BATCH = 16
EPOCHS, TRAIN_BATCHES = 2, 2
VOLUME = (40, 512, 512)
VOLUMES = 2
SKIN_SPLITS = (32, 8, 8)  # train, val, test images


def _launches(**counts) -> dict:
    return {fn.__name__: counts.get(fn.__name__, 0) for fn in kernels.WRAPPERS}


# kernel launches per training step: the flagship's 12 deform convs, each
# once forward and once backward; the LKA Baseline's 6 chains forward
# (their backward is the plain chain's VJP)
LAUNCHES_PER_STEP = {"dlka": _launches(deform_dw_conv2d=12, deform_dw_conv2d_bwd=12),
                     "lka_baseline": _launches(dw_chain2d=6)}


def _organs(rng, shape, labels: int):
    """(image in [0, 1], label map): soft tissue texture in an elliptic
    body and `labels - 1` organ ellipses of their own intensities, later
    ones over earlier ones."""
    g = case_path.grid(shape)
    body = sum((gi / ri) ** 2 for gi, ri in zip(g, (0.9,) * len(shape))) < 1
    texture = gaussian_filter(rng.randn(*shape).astype(np.float32), 2.0) * 0.05
    image = np.where(body, 0.35 + texture, 0.0).astype(np.float32)
    label = np.zeros(shape, np.uint8)
    centres = rng.uniform(-0.5, 0.5, (labels - 1, len(shape)))
    radii = rng.uniform(0.08, 0.25, (labels - 1, len(shape)))
    for lab, (c, r) in enumerate(zip(centres, radii), start=1):
        inside = body & (sum(((gi - ci) / ri) ** 2 for gi, ci, ri in zip(g, c, r)) < 1)
        label[inside] = lab
        image[inside] = rng.uniform(0.4, 0.9) + texture[inside]
    image += rng.randn(*shape).astype(np.float32) * 0.02
    return np.clip(image, 0.0, 1.0), label


def write_slices(root, list_dir, n: int = BATCH * TRAIN_BATCHES, size: int = SLICE,
                 num_classes: int = NUM_CLASSES, seed: int = 0) -> list:
    """`n` synthetic slices `case0000_slice000`… as `<root>/<name>.npz` and
    their names in `<list_dir>/train.txt`; returns the names."""
    root, list_dir = Path(root), Path(list_dir)
    root.mkdir(parents=True, exist_ok=True)
    list_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    names = []
    for i in range(n):
        image, label = _organs(rng, (size, size), num_classes)
        name = f"case{i // 100:04d}_slice{i % 100:03d}"
        np.savez(root / f"{name}.npz", image=image, label=label)
        names.append(name)
    (list_dir / "train.txt").write_text("\n".join(names) + "\n")
    return names


def volumes(n: int = VOLUMES, shape=VOLUME, num_classes: int = NUM_CLASSES,
            seed: int = 100) -> list:
    """`n` synthetic test volumes as (image (S, H, W) float32, label (S, H,
    W) int32, name) triples, each slice drawn as `write_slices` draws
    one."""
    rng = np.random.RandomState(seed)
    out = []
    for v in range(n):
        pairs = [_organs(rng, shape[1:], num_classes) for _ in range(shape[0])]
        out.append((np.stack([p[0] for p in pairs]),
                    np.stack([p[1] for p in pairs]).astype(np.int32), f"case{v:04d}"))
    return out


def write_skin(root, splits=SKIN_SPLITS, size: int = IMG, seed: int = 0) -> Path:
    """`data_/mask_{train,val,test}.npy` as upstream's Prepare_ISIC2017.py
    writes them (float64 RGB 0-255 images, masks 0 / 255), each image a
    skin-toned field with one darker lesion ellipse, its mask."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    g = case_path.grid((size, size))
    for split, n in zip(("train", "val", "test"), splits):
        data = np.zeros((n, size, size, 3))
        mask = np.zeros((n, size, size))
        for i in range(n):
            centre = rng.uniform(-0.3, 0.3, 2)
            radii = rng.uniform(0.2, 0.5, 2)
            inside = sum(((gi - ci) / ri) ** 2 for gi, ci, ri in zip(g, centre, radii)) < 1
            skin = rng.uniform(150, 220, 3)
            lesion = skin * rng.uniform(0.3, 0.7)
            texture = gaussian_filter(rng.randn(size, size), 3.0)[..., None] * 20
            data[i] = np.clip(np.where(inside[..., None], lesion, skin) + texture, 0, 255)
            mask[i] = inside * 255.0
        np.save(root / f"data_{split}.npy", data)
        np.save(root / f"mask_{split}.npy", mask)
    return root


def synthetic_batch(seed: int = 0, batch: int = BATCH, img: int = IMG,
                    num_classes: int = NUM_CLASSES) -> dict:
    """One Synapse training batch drawn at the model's size: image (B, img,
    img, 1) float32 through `normalize_05`, label (B, img, img) int32."""
    rng = np.random.RandomState(seed)
    pairs = [_organs(rng, (img, img), num_classes) for _ in range(batch)]
    return {"image": normalize_05(np.stack([p[0] for p in pairs]))[..., None],
            "label": np.stack([p[1] for p in pairs]).astype(np.int32)}


def step_trainer(out_dir, config: str = "dlka", seed: int = SEED, img: int = IMG,
                 device="cuda") -> Trainer2D:
    """A `Trainer2D` ready to step: the model as `cli.train_synapse2d`
    builds it ("dlka": the flagship, "lka_baseline": `--no_deform`), a
    fresh optimizer, the path's LR schedule (2 epochs of 2 batches)."""
    factory = {"dlka": maxvit_dlka_former, "lka_baseline": maxvit_lka_former}[config]
    trainer = Trainer2D(factory(NUM_CLASSES, img_size=img, seed=seed, device=device),
                        out_dir, None, max_epochs=EPOCHS, iterations_per_epoch=TRAIN_BATCHES)
    trainer.initialize()
    return trainer


def synapse_argv(root, list_dir, out, *extra, img: int = IMG, batch: int = BATCH,
                 epochs: int = EPOCHS, device="cuda") -> list:
    """The `cli.train_synapse2d` arguments of the Synapse path: the eval
    hook at the last epoch."""
    return ["--root_path", str(root), "--list_dir", str(list_dir), "--output_dir", str(out),
            "--num_classes", str(NUM_CLASSES), "--max_epochs", str(epochs),
            "--batch_size", str(batch), "--img_size", str(img),
            "--eval_interval", str(epochs), "--device", device, *extra]


def skin_argv(root, out, *extra, img: int = IMG, batch: int = SKIN_BATCH,
              epochs: int = EPOCHS, device="cuda") -> list:
    """The `cli.train_skin` arguments of the skin path, test evaluation on."""
    return ["--root_path", str(root), "--output_dir", str(out), "--batch_size", str(batch),
            "--max_epochs", str(epochs), "--img_size", str(img), "--evaluate",
            "--device", device, *extra]


class Recorder:
    """Inside `with Recorder() as rec:` the host seconds of each training
    step of both trainers (`step`, from the host batch to the loss on the
    host), of loading and augmenting a Synapse batch (`batch`) and of the
    checkpoint writes (`checkpoint_write`, on the saving thread) go to
    `rec.times[key]`, and the kernel launches of each step to
    `rec.launches`. The trainers keep their epochs' seconds
    (`epoch_times`)."""

    def __init__(self):
        self.times = defaultdict(list)
        self.launches = []
        self._stack = contextlib.ExitStack()

    def _step(self, fn):
        times = self.times["step"]

        def wrapped(*args, **kwargs):
            kernels.reset_launches()
            t0 = time.perf_counter()
            loss = fn(*args, **kwargs)
            float(loss)  # the host waits for the step
            times.append(time.perf_counter() - t0)
            self.launches.append(kernels.launch_counts())
            return loss
        return wrapped

    def __enter__(self):
        for owner, name, new in (
                (Trainer2D, "train_step", self._step(Trainer2D.train_step)),
                (TrainerSkin, "train_step", self._step(TrainerSkin.train_step)),
                (SynapseLoader2D, "next", timed(SynapseLoader2D.next, self.times["batch"])),
                (CheckpointManager, "_write",
                 timed(CheckpointManager._write, self.times["checkpoint_write"]))):
            self._stack.enter_context(mock.patch.object(owner, name, new))
        return self

    def __exit__(self, *exc):
        self._stack.close()


def _median(xs) -> float:
    return float(np.median(xs)) if len(xs) else float("nan")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    def peak() -> str:
        if not args.device.startswith("cuda"):
            return "peak device memory not measured (CPU)"
        gib = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        return f"peak device memory {gib:.3f} GiB"

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_slices(tmp / "slices", tmp / "lists")
        cases = volumes()
        with Recorder() as rec:
            trainer = train_synapse2d.main(
                synapse_argv(tmp / "slices", tmp / "lists", tmp / "out", device=args.device),
                eval_cases=cases)
        t = rec.times
        print(f"Synapse 2D trainer: {_median(t['step'][1:]):.3f} s/step (median after the "
              f"first), host seconds per batch (load and augment) {_median(t['batch']):.3f}; "
              f"epochs {[round(s, 3) for s in trainer.epoch_times]} s; checkpoint writes {[round(s, 3) for s in t['checkpoint_write']]} s; losses "
              f"{trainer.losses}; eval hook {trainer.eval_results}; launches per step "
              f"{rec.launches[0]}; {peak()}", flush=True)
        with Recorder() as rec:
            trainer = train_skin.main(skin_argv(write_skin(tmp / "skin"), tmp / "skin_out",
                                                device=args.device))
        t = rec.times
        print(f"skin trainer: {_median(t['step'][1:]):.3f} s/step, epochs "
              f"{[round(s, 3) for s in trainer.epoch_times]} s, best val loss "
              f"{trainer.best_val_loss:.5f}, plateau scale {trainer.scheduler.scale}, test "
              f"{ {k: round(trainer.test_metrics['best'][k], 4) for k in ('dsc', 'accuracy')} }; "
              f"launches per step {rec.launches[0]}; {peak()}", flush=True)


if __name__ == "__main__":
    main()
