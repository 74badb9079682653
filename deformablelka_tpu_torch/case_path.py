"""The port's 3D case paths: what a 3D user runs around the model.

- **Synapse** (`cli/predict_simple.py`): a folder of NIfTI cases is
  preprocessed to the target spacing (3.0, 0.76, 0.76), predicted by
  `dlka_former_synapse(14, do_ds=False)` at patch 64×128×128, step 0.5,
  8 mirror flips in one batch-8 forward, averaged over two folds on the
  device, restored to each case's geometry on the host and written as
  uint8 labels. `ct_case` is a synthetic CT-like case, int16 Hounsfield
  units, on disk (77, 162, 135) at spacing (3.75, 0.9, 0.9): it is
  resampled (separate z) to (96, 192, 160), 8 tiles, and the restore
  resamples back. `write_fold_checkpoints` writes the two folds' weights,
  random from seeds 0 and 1 with the gates driven
  (`main_path.drive_gates`), through the port's `CheckpointManager`.
- **Pancreas** (`inference/pancreas.py`, the tester behind
  `cli/test_pancreas.py`): `dlka_net_pancreas` at patch 96³, stride 16/16,
  no mirroring, count blending, on `pancreas_case`, a synthetic
  128×128×80 volume and label held in memory (z is padded to 96: 3×3×1
  tiles), scored by Dice, Jaccard, HD95 and ASD; the model's weights are
  random from seed 0 with the gates driven.

    python -m deformablelka_tpu_torch.case_path [--device cpu]

builds both in a temporary directory, runs them once and prints the
seconds per case, the host's share and the metrics. `chip_smoke.py`
(phases 15-16) drives the same paths on the card.
"""

from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path

import numpy as np
from scipy.ndimage import gaussian_filter

from deformablelka_tpu_torch.data import nifti
from deformablelka_tpu_torch.main_path import drive_gates
from deformablelka_tpu_torch.training.checkpoint import CheckpointManager

NUM_CLASSES = 14
PATCH = (64, 128, 128)
TARGET_SPACING = (3.0, 0.76, 0.76)
CASE_SHAPE = (77, 162, 135)
CASE_SPACING = (3.75, 0.9, 0.9)
FOLDS = (0, 1)
CHECKPOINT = "model_final_checkpoint"
PANCREAS_PATCH = (96, 96, 96)
PANCREAS_VOLUME = (128, 128, 80)
PANCREAS_STRIDE = 16


def blobs(rng, n, radius):
    """(centres, radii) of `n` ellipsoids in the [-1, 1]³ grid of `grid`."""
    return rng.uniform(-0.5, 0.5, (n, 3)), rng.uniform(*radius, (n, 3))


def grid(shape):
    return np.meshgrid(*[np.linspace(-1, 1, s, dtype=np.float32) for s in shape],
                       indexing="ij")


def ct_case(seed: int = 0, shape=CASE_SHAPE) -> nifti.NiftiImage:
    """A CT-like int16 volume in Hounsfield units: air (-1000) around an
    elliptic body (soft tissue ~40 HU with smooth texture), organs of
    30-250 HU and a bone rim; affine diag(CASE_SPACING) with an origin."""
    rng = np.random.RandomState(seed)
    g = grid(shape)
    body = (g[0] / 0.95) ** 2 + (g[1] / 0.85) ** 2 + (g[2] / 0.75) ** 2 < 1
    texture = gaussian_filter(rng.randn(*shape).astype(np.float32), 2.0) * 60
    hu = np.where(body, 40 + texture, -1000).astype(np.float32)
    centres, radii = blobs(rng, 8, (0.12, 0.3))
    for (c, r), value in zip(zip(centres, radii), rng.uniform(30, 250, 8)):
        inside = sum(((gi - ci) / ri) ** 2 for gi, ci, ri in zip(g, c, r)) < 1
        hu[inside & body] = value + texture[inside & body] * 0.3
    rim = body & ((g[1] / 0.8) ** 2 + (g[2] / 0.7) ** 2 > 0.85)
    hu[rim] = 400
    hu += rng.randn(*shape).astype(np.float32) * 10
    affine = np.diag([*CASE_SPACING, 1.0])
    affine[:3, 3] = (-120.0, -75.0, 30.0)
    return nifti.NiftiImage(np.clip(hu, -1024, 3071).astype(np.int16), affine)


def write_case(folder, seed: int = 0, name: str = "case_000.nii.gz", **kw) -> Path:
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    nifti.save(ct_case(seed, **kw), folder / name)
    return folder / name


def write_fold_checkpoints(model_folder) -> None:
    """`model_folder/fold_<f>/ckpt/model_final_checkpoint` for each fold:
    `dlka_former_synapse` from seed f, gates driven from seed f + 11."""
    from deformablelka_tpu_torch.models.dlka_former import dlka_former_synapse
    for f in FOLDS:
        model = dlka_former_synapse(NUM_CLASSES, do_ds=False, img_size=PATCH, seed=f,
                                    device="cpu")
        drive_gates(model, seed=f + 11)
        CheckpointManager(Path(model_folder) / f"fold_{f}" / "ckpt",
                          async_save=False).save(CHECKPOINT, {"model": model.state_dict()})


def predict_simple_argv(input_folder, output_folder, model_folder, patch=PATCH,
                        device="cuda") -> list:
    """The `cli.predict_simple` arguments of the Synapse path: TTA on,
    step 0.5, CT normalisation, target spacing (3.0, 0.76, 0.76)."""
    return ["-i", str(input_folder), "-o", str(output_folder),
            "--model_folder", str(model_folder), "-f", *map(str, FOLDS),
            "-chk", CHECKPOINT, "--step_size", "0.5",
            "--num_classes", str(NUM_CLASSES), "--patch_size", *map(str, patch),
            "--target_spacing", *map(str, TARGET_SPACING), "--device", device]


def pancreas_case(seed: int = 0, shape=PANCREAS_VOLUME) -> tuple:
    """("pancreas_000", image (W, H, D) float32, label (W, H, D) int32): a
    smooth z-scored volume whose label, one ellipsoid, is brighter."""
    rng = np.random.RandomState(seed)
    g = grid(shape)
    c, r = blobs(rng, 1, (0.2, 0.35))
    label = (sum(((gi - ci) / ri) ** 2 for gi, ci, ri in zip(g, c[0], r[0])) < 1)
    image = gaussian_filter(rng.randn(*shape).astype(np.float32), 1.5) * 2
    image = (image + 1.5 * label).astype(np.float32)
    image = (image - image.mean()) / image.std()
    return "pancreas_000", image, label.astype(np.int32)


def pancreas_model(seed: int = 0, device="cuda"):
    """`dlka_net_pancreas` at its 96³ patch from `seed`, gates driven from
    seed + 11."""
    from deformablelka_tpu_torch.models.dlka_former import dlka_net_pancreas
    model = dlka_net_pancreas(img_size=PANCREAS_PATCH, seed=seed, device=device)
    drive_gates(model, seed=seed + 11)
    return model


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from deformablelka_tpu_torch.cli import predict_simple
    from deformablelka_tpu_torch.inference import pancreas
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_case(tmp / "in")
        write_fold_checkpoints(tmp / "run")
        t0 = time.perf_counter()
        predictor = predict_simple.main(predict_simple_argv(
            tmp / "in", tmp / "out", tmp / "run", device=args.device))
        print(f"Synapse case {CASE_SHAPE} at {CASE_SPACING}: "
              f"{time.perf_counter() - t0:.3f} s with the models' build; "
              f"{predictor.last_case}", flush=True)
    sw = pancreas.make_pancreas_sliding_window(
        pancreas_model(device=args.device), patch_size=PANCREAS_PATCH,
        stride_xy=PANCREAS_STRIDE, stride_z=PANCREAS_STRIDE, device=args.device)
    t0 = time.perf_counter()
    avg = pancreas.test_all_case(sw, [pancreas_case()], verbose=False)
    print(f"Pancreas case {PANCREAS_VOLUME}: {time.perf_counter() - t0:.3f} s, "
          f"(dice, jaccard, hd95, asd) {avg}", flush=True)


if __name__ == "__main__":
    main()
