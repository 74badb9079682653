"""The port's 3D training paths, driven through their entry points.

- **Synapse** (`cli/run_training.py`): a seeded synthetic preprocessed
  folder in nnUNet's layout (`write_preprocessed`: 3 CT-like cases of
  (96, 192, 160), the bench volume's size, 14 labels; `<case>.npz` holds
  `data` (2, x, y, z), the image then the seg, `<case>.pkl` the
  `class_locations`) trains `dlka_former_synapse(14, do_ds=True,
  remat=True)` at patch 64×128×128, batch 2, moreDA augmentation in 4
  threads, for 2 epochs of 4 training and 2 validation batches (the
  first case trains, the other two validate); `-val` then predicts the
  validation cases (step 0.5, 8 flips in one batch-8 forward) and writes
  `summary.json`; `-c` resumes from `model_latest`.
- **Pancreas** (`training/trainer_pancreas.py`, the engine of
  `cli/train_pancreas.py`): `dlka_net_pancreas` at 96³ from seed 1337 (the
  CLI's), batch 2 with the loss on the first sample (`labeled_bs` 1), 6
  iterations over a `PancreasDataLoader` whose cache holds a seeded
  128×128×80 case (`case_path.pancreas_case`: no h5 file, so no h5py),
  then the port's Pancreas tester on the checkpoint it wrote,
  `d_lka_former_iter_6`, loaded as `cli/test_pancreas.py` loads it.

    python -m deformablelka_tpu_torch.trainer_path [--device cpu]

runs both in a temporary directory and prints s/step (the median after
the first), the step's wait on the prefetch queue, the host seconds of
loading and augmenting a batch, s/epoch, the checkpoint writes, s per
Pancreas iteration and the tester's metrics. `Recorder` times the
pieces; `chip_smoke.py` (phases 17-18) drives the same paths on the card
and holds them against the plain versions.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pickle
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import numpy as np
from scipy.ndimage import gaussian_filter

from deformablelka_tpu_torch import case_path
from deformablelka_tpu_torch.cli import run_training
from deformablelka_tpu_torch.cli._pancreas_models import build_pancreas_model
from deformablelka_tpu_torch.data.augment import ThreadedAugmenter
from deformablelka_tpu_torch.data.dataset import compute_class_locations, load_dataset
from deformablelka_tpu_torch.data.pancreas import PancreasDataLoader
from deformablelka_tpu_torch.inference import pancreas
from deformablelka_tpu_torch.main_path import BLOCKS
from deformablelka_tpu_torch.ops import kernels
from deformablelka_tpu_torch.profiling import timed
from deformablelka_tpu_torch.training.checkpoint import CheckpointManager
from deformablelka_tpu_torch.training.trainer3d import Trainer3D
from deformablelka_tpu_torch.training.trainer_pancreas import TrainerPancreas

NUM_CLASSES = 14
PATCH = (64, 128, 128)
STEM = (2, 4, 4)
CASE_SHAPE = (96, 192, 160)
CASES = 3
BATCH = 2
EPOCHS, TRAIN_BATCHES, VAL_BATCHES = 2, 4, 2
PANCREAS_SEED = 1337
PANCREAS_ITERATIONS = 6
PANCREAS_LABELED = 1


# kernel launches of the published block's paths: a Synapse step with remat
# (each block's forward again in the backward pass), a validation batch (one
# forward), a Pancreas iteration without remat (at 96³, B=2: 114 of its 153
# dense stride-1 convs, all but the 21 at 6³ and the 18 of 3³ at 12³)
LAUNCHES_PER_STEP = {"deform_conv3d": 2 * BLOCKS, "dw_chain3d": 2 * BLOCKS,
                     "deform_conv3d_bwd": BLOCKS, "dw_chain3d_bwd": BLOCKS, "conv3d_wgrad": 116}
LAUNCHES_PER_VAL_BATCH = {"deform_conv3d": BLOCKS, "dw_chain3d": BLOCKS}
PANCREAS_LAUNCHES_PER_ITERATION = {"deform_conv3d": BLOCKS, "dw_chain3d": BLOCKS,
                                   "deform_conv3d_bwd": BLOCKS, "dw_chain3d_bwd": BLOCKS,
                                   "conv3d_wgrad": 114}


def synapse_case(seed: int = 0, shape=CASE_SHAPE, num_classes: int = NUM_CLASSES):
    """(image (x, y, z) float32, seg (x, y, z) int16): a CT-like volume
    after nnUNet's CT normalisation, air at -2 around an elliptic body of
    smooth texture, with `num_classes - 1` organ ellipsoids of their own
    intensities (labels 1…), later ones over earlier ones."""
    rng = np.random.RandomState(seed)
    g = case_path.grid(shape)
    body = (g[0] / 0.95) ** 2 + (g[1] / 0.85) ** 2 + (g[2] / 0.75) ** 2 < 1
    texture = gaussian_filter(rng.randn(*shape).astype(np.float32), 2.0) * 0.5
    image = np.where(body, texture, -2.0).astype(np.float32)
    seg = np.zeros(shape, np.int16)
    centres, radii = case_path.blobs(rng, num_classes - 1, (0.1, 0.3))
    for label, (c, r) in enumerate(zip(centres, radii), start=1):
        inside = body & (sum(((gi - ci) / ri) ** 2 for gi, ci, ri in zip(g, c, r)) < 1)
        seg[inside] = label
        image[inside] = rng.uniform(-1.0, 2.0) + 0.3 * texture[inside]
    image += rng.randn(*shape).astype(np.float32) * 0.1
    return image, seg


def write_preprocessed(folder, cases: int = CASES, shape=CASE_SHAPE,
                       num_classes: int = NUM_CLASSES, seed: int = 0) -> list:
    """`cases` synthetic cases `case_000`… in nnUNet's preprocessed layout;
    returns their names."""
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    names = []
    for i in range(cases):
        image, seg = synapse_case(seed + i, shape, num_classes)
        name = f"case_{i:03d}"
        np.savez(folder / f"{name}.npz", data=np.stack([image, seg.astype(np.float32)]))
        locations = compute_class_locations(seg, range(1, num_classes),
                                            rng=np.random.RandomState(seed + i))
        with open(folder / f"{name}.pkl", "wb") as f:
            pickle.dump({"class_locations": locations}, f)
        names.append(name)
    return names


def run_training_argv(pre, out, *extra, patch=PATCH, epochs: int = EPOCHS,
                      device="cuda") -> list:
    """The `cli.run_training` arguments of the Synapse path."""
    return ["3d_fullres", "d_lka_former_trainer_synapse", "Task002_Synapse", "0",
            "--preprocessed_folder", str(pre), "--output_folder", str(out),
            "--patch_size", *map(str, patch), "--num_classes", str(NUM_CLASSES),
            "--batch_size", str(BATCH), "--max_epochs", str(epochs),
            "--batches_per_epoch", str(TRAIN_BATCHES),
            "--val_batches_per_epoch", str(VAL_BATCHES), "--device", device, *extra]


def synchronous_batch(pre, patch=PATCH, seed: int = 1234) -> dict:
    """The CLI's first training batch as its pipeline makes it (the
    training cases, the enlarged patch, moreDA, the seeds of
    `run_training.main`), loaded and augmented in the caller's thread."""
    train, _ = run_training.split_cases(load_dataset(pre))
    loader, transform = run_training.make_pipeline(
        train, patch, BATCH, seed, True, "moreDA",
        run_training.deep_supervision_scales(STEM))
    return transform(loader.next())


class Recorder:
    """Inside `with Recorder() as rec:` the host seconds of each call of
    the trainer's steps (`step`, ending with the loss on the host),
    validation batches (`val_batch`, up to their enqueue), epochs
    (`epoch`), the prefetch queue's `next` (`wait`), the checkpoint writes
    (`checkpoint_write`, on the saving thread) and, in the augmenter's
    threads, of loading and of augmenting each training batch (`load`,
    `augment`; `load_val`, `augment_val` for validation batches) go to
    `rec.times[key]`; the kernel launches of each step and validation
    batch to `rec.launches[key]`."""

    def __init__(self):
        self.times = defaultdict(list)
        self.launches = defaultdict(list)
        self._stack = contextlib.ExitStack()

    def _counted(self, fn, key: str):
        call, launches = timed(fn, self.times[key]), self.launches[key]

        def wrapped(*args, **kwargs):
            kernels.reset_launches()
            out = call(*args, **kwargs)
            launches.append(kernels.launch_counts())
            return out
        return wrapped

    def _pipeline(self, make_pipeline):
        def wrapped(dataset, patch, batch_size, seed, train, *args, **kwargs):
            loader, transform = make_pipeline(dataset, patch, batch_size, seed, train,
                                              *args, **kwargs)
            tag = "" if train else "_val"
            timed_loader = SimpleNamespace(next=timed(loader.next, self.times["load" + tag]))
            return timed_loader, timed(transform, self.times["augment" + tag])
        return wrapped

    def __enter__(self):
        for owner, name, new in (
                (Trainer3D, "train_batch", self._counted(Trainer3D.train_batch, "step")),
                (Trainer3D, "evaluate", self._counted(Trainer3D.evaluate, "val_batch")),
                (Trainer3D, "run_epoch", timed(Trainer3D.run_epoch, self.times["epoch"])),
                (ThreadedAugmenter, "next", timed(ThreadedAugmenter.next, self.times["wait"])),
                (CheckpointManager, "_write",
                 timed(CheckpointManager._write, self.times["checkpoint_write"])),
                (run_training, "make_pipeline", self._pipeline(run_training.make_pipeline))):
            self._stack.enter_context(mock.patch.object(owner, name, new))
        return self

    def __exit__(self, *exc):
        self._stack.close()


def pancreas_loader(seed: int = 0, shape=case_path.PANCREAS_VOLUME,
                    crop=case_path.PANCREAS_PATCH, batch_size: int = BATCH):
    """A `PancreasDataLoader` (seed `seed`) over one case held in its
    cache: `case_path.pancreas_case(seed, shape)`."""
    name, image, label = case_path.pancreas_case(seed, shape)
    loader = PancreasDataLoader([name], crop_size=crop, batch_size=batch_size,
                                seed=seed)
    loader._cache[name] = (image, label)
    return loader


def pancreas_model(patch=case_path.PANCREAS_PATCH, device="cuda", model="dlka_net"):
    """The Pancreas model `model` (`dlka_net_pancreas` unless asked: a
    baseline, `vnet`, `resnet34` or `unetr`) as `cli/train_pancreas.py`
    builds it."""
    return build_pancreas_model(model, "TransformerBlock_3D_single_deform_LKA",
                                patch, device=device, seed=PANCREAS_SEED)


def train_pancreas(out_dir, iterations: int = PANCREAS_ITERATIONS,
                   patch=case_path.PANCREAS_PATCH, shape=case_path.PANCREAS_VOLUME,
                   device="cuda", model="dlka_net"):
    """(trainer, [(seconds, loss, launches) per iteration]): the Pancreas
    trainer of `model` for `iterations`, its checkpoint written to
    `out_dir`."""
    trainer = TrainerPancreas(pancreas_model(patch, device, model), out_dir,
                              max_iterations=iterations, batch_size=BATCH,
                              labeled_bs=PANCREAS_LABELED)
    record = []
    t0 = [time.perf_counter()]

    def callback(it, model, metrics):
        loss = float(metrics["loss"])  # the host waits for the iteration
        record.append((time.perf_counter() - t0[0], loss, kernels.launch_counts()))
        kernels.reset_launches()
        t0[0] = time.perf_counter()

    kernels.reset_launches()
    trainer.run_training(pancreas_loader(0, shape, patch), log_every=0,
                         callback=callback)
    return trainer, record


def test_pancreas_checkpoint(out_dir, iterations: int = PANCREAS_ITERATIONS,
                             patch=case_path.PANCREAS_PATCH,
                             shape=case_path.PANCREAS_VOLUME, device="cuda",
                             model="dlka_net"):
    """The port's Pancreas tester (stride 16, as `cli/test_pancreas.py`)
    on the trainer's case with the weights of `d_lka_former_iter_<N>` of
    `model`: (dice, jaccard, hd95, asd)."""
    model = pancreas_model(patch, device, model)
    state, _ = CheckpointManager(out_dir).load(f"d_lka_former_iter_{iterations}")
    model.load_state_dict(state["model"], strict=True)
    sw = pancreas.make_pancreas_sliding_window(
        model.eval(), patch_size=patch, stride_xy=case_path.PANCREAS_STRIDE,
        stride_z=case_path.PANCREAS_STRIDE, device=device)
    return pancreas.test_all_case(sw, [case_path.pancreas_case(0, shape)], verbose=False)


def _median(xs) -> float:
    return float(np.median(xs)) if len(xs) else float("nan")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_preprocessed(tmp / "pre")
        argv = run_training_argv(tmp / "pre", tmp / "out", device=args.device)
        with Recorder() as rec:
            trainer = run_training.main(argv)
        t = rec.times
        print(f"Synapse trainer: {_median(t['step'][1:]):.3f} s/step (median after the "
              f"first), queue wait {_median(t['wait']):.3f} s, host seconds per batch: "
              f"load {_median(t['load']):.3f}, augment {_median(t['augment']):.3f}; "
              f"epochs {[round(s, 3) for s in t['epoch']]} s; checkpoint writes "
              f"{[round(s, 3) for s in t['checkpoint_write']]} s; losses "
              f"{trainer.all_tr_losses}", flush=True)
        t0 = time.perf_counter()
        run_training.main(argv + ["-val"])
        summary = json.loads((trainer.output_folder / "validation" / "summary.json").read_text())
        dice = [summary["results"]["mean"][str(c)]["Dice"] for c in range(1, NUM_CLASSES)]
        print(f"Synapse -val: {time.perf_counter() - t0:.3f} s, mean foreground Dice "
              f"{np.nanmean(dice):.4f}", flush=True)
        trainer, record = train_pancreas(tmp / "pancreas", device=args.device)
        print(f"Pancreas trainer: s/iteration {[round(s, 3) for s, _, _ in record]}, "
              f"losses {[round(l, 5) for _, l, _ in record]}", flush=True)
        avg = test_pancreas_checkpoint(tmp / "pancreas", device=args.device)
        print(f"Pancreas tester on d_lka_former_iter_{PANCREAS_ITERATIONS}: (dice, "
              f"jaccard, hd95, asd) {avg.tolist()}", flush=True)


if __name__ == "__main__":
    main()
