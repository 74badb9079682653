"""The port's Pancreas baselines and nnUNet's 2D GenericUNet, driven
through their entry points.

- **Pancreas baselines** (`cli/_pancreas_models.py`, the models of
  `cli/train_pancreas.py --model`): VNet, the ResNet34 seg net and UNETR
  at full width from the CLI's seed 1337, each trained by
  `TrainerPancreas` as `trainer_path.train_pancreas` trains D-LKA Net
  (96³, batch 2, `labeled_bs` 1, 6 iterations on the seeded 128×128×80
  case), then scored by the Pancreas tester on its checkpoint (stride 16).
- **GenericUNet 2D from raw data**: `write_raw_task` writes a
  decathlon-style raw task of three CT-like NIfTI cases (64×288×288 at
  in-plane 0.75-0.8 mm, z 2.5-3.0 mm, labels organ and bone from the
  intensities), `data/experiment_planning.plan_and_preprocess` plans and
  preprocesses it (z is resampled: the spacings differ), and
  `cli/run_training.main` trains `2d` on the planned folder: GenericUNet
  at the CLI's 256² patch, batch 2, 1 epoch of 2 training batches and
  one validation batch.

    python -m deformablelka_tpu_torch.baselines_path [--device cpu]

runs both in a temporary directory and prints s/iteration, the tester's
metrics, the planning's host seconds and s/step. `chip_smoke.py` (phase
23) drives the same paths on the card. No hand-written kernel runs on
either path.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np

from deformablelka_tpu_torch import case_path, trainer_path
from deformablelka_tpu_torch.cli import run_training
from deformablelka_tpu_torch.data import nifti
from deformablelka_tpu_torch.data.experiment_planning import plan_and_preprocess

BASELINES = ("vnet", "resnet34", "unetr")
RAW_SHAPE = (64, 288, 288)
RAW_SPACINGS = ((3.0, 0.8, 0.8), (3.0, 0.8, 0.8), (2.5, 0.75, 0.75))
RAW_LABELS = {"0": "background", "1": "organ", "2": "bone"}
PATCH_2D = (256, 256)  # the CLI's default
BATCHES_2D = 2


def write_raw_task(root, shape=RAW_SHAPE, spacings=RAW_SPACINGS) -> Path:
    """imagesTr/case_00i_0000.nii.gz (int16 HU, `case_path.ct_case`),
    labelsTr/case_00i.nii.gz (1: 100-300 HU, 2: ≥ 350 HU, the bone rim) and
    dataset.json, one case per spacing."""
    root = Path(root)
    (root / "imagesTr").mkdir(parents=True)
    (root / "labelsTr").mkdir()
    training = []
    for i, spacing in enumerate(spacings):
        image = case_path.ct_case(i, shape)
        hu = image.data
        label = np.where(hu >= 350, 2, np.where((hu >= 100) & (hu < 300), 1, 0))
        affine = image.affine.copy()
        affine[:3, :3] = np.diag(spacing)
        name = f"case_{i:03d}"
        nifti.save(nifti.NiftiImage(hu, affine), root / "imagesTr" / f"{name}_0000.nii.gz")
        nifti.save(nifti.NiftiImage(label.astype(np.uint8), affine),
                   root / "labelsTr" / f"{name}.nii.gz")
        training.append({"image": f"./imagesTr/{name}.nii.gz",
                         "label": f"./labelsTr/{name}.nii.gz"})
    (root / "dataset.json").write_text(json.dumps({
        "name": "CTSynthetic", "modality": {"0": "CT"}, "labels": RAW_LABELS,
        "training": training}))
    return root


def plan(raw, pre) -> tuple:
    """(plans, host seconds) of `plan_and_preprocess(raw, pre)`."""
    t0 = time.perf_counter()
    plans = plan_and_preprocess(raw, pre)
    return plans, time.perf_counter() - t0


def run_training_2d_argv(pre, out, *extra, device="cuda") -> list:
    """`run_training 2d` at the CLI's defaults (256² patch, batch 2) on
    the planned folder: 1 epoch of `BATCHES_2D` training batches and one
    validation batch."""
    return ["2d", "d_lka_former_trainer_synapse", "Task001_CTSynthetic", "0",
            "--preprocessed_folder", str(pre), "--output_folder", str(out),
            "--num_classes", str(len(RAW_LABELS)), "--max_epochs", "1",
            "--batches_per_epoch", str(BATCHES_2D), "--val_batches_per_epoch", "1",
            "--device", device, *extra]


def synchronous_batch_2d(pre, seed: int = 1234) -> dict:
    """The 2D CLI's first training batch as its pipeline makes it (the
    training cases, the enlarged patch, moreDA, the CLI's seed), loaded
    and augmented in the caller's thread."""
    from deformablelka_tpu_torch.data.dataset import load_dataset, unpack_dataset

    unpack_dataset(pre)
    train, _ = run_training.split_cases(load_dataset(pre))
    loader, transform = run_training.make_pipeline(
        train, PATCH_2D, 2, seed, True, "moreDA", run_training.DS_SCALES_2D)
    return transform(loader.next())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for name in BASELINES:
            _, record = trainer_path.train_pancreas(tmp / name, device=args.device,
                                                    model=name)
            avg = trainer_path.test_pancreas_checkpoint(tmp / name, device=args.device,
                                                        model=name)
            print(f"{name}: s/iteration {[round(s, 4) for s, _, _ in record]}, losses "
                  f"{[round(l, 5) for _, l, _ in record]}; tester (dice, jaccard, hd95, "
                  f"asd) {avg.tolist()}", flush=True)
        write_raw_task(tmp / "raw")
        plans, secs = plan(tmp / "raw", tmp / "pre")
        print(f"plan_and_preprocess: {secs:.3f} s, stage 0 "
              f"{plans['plans_per_stage'][0]}", flush=True)
        with trainer_path.Recorder() as rec:
            trainer = run_training.main(run_training_2d_argv(tmp / "pre", tmp / "out",
                                                             device=args.device))
        print(f"run_training 2d: steps {[round(s, 4) for s in rec.times['step']]} s, "
              f"losses {trainer.all_tr_losses}, validation {trainer.all_val_losses}",
              flush=True)


if __name__ == "__main__":
    main()
