"""3D and 2D training CLI (the port's `deformablelka_tpu/cli/run_training.py`).

Mirrors upstream's run/run_training.py:42-101:

    python -m deformablelka_tpu_torch.cli.run_training 3d_fullres|2d
        d_lka_former_trainer_synapse TASK FOLD --preprocessed_folder PRE
        [--output_folder OUT] [-c] [-val] [--trans_block X]
        [--patch_size 64 128 128] [--da moreDA|insaneDA|noDA]
        [--device cuda|cpu]

trains `dlka_former_synapse(num_classes, do_ds=True, remat=True)` (the
ACDC model for `*_acdc` trainers) with `Trainer3D` on the preprocessed
cases (the first 60 % train, the rest validate; 18 / 12 for 30 cases),
fed by `DataLoader3D` and the augmentation in 4 threads each
(`ThreadedAugmenter`). `-c` resumes from `model_latest`; `-val` predicts
every validation case with the sliding window (step 0.5, 8 mirror flips
in one batch-8 forward) from the final (else best, else latest)
checkpoint and writes `validation/summary.json` and
`validation/postprocessing.json`. Runs on the card unless `--device cpu`,
in float32 (the JAX CLI's `-val` casts the tile to bfloat16; the port's
kernels take float32 only). `main` returns the trainer; it stops the
augmenters' threads before it returns.

`network 2d` is nnUNet's `2d` configuration on the same preprocessed
cases: `GenericUNet(num_classes, ndim=2, num_pool=5, do_ds=True)` on
random slices (`DataLoader2D`) at the last two axes of `--patch_size`
(else 256²), mirrored in-plane only, deep supervision at 1, 1/2 and 1/4.
`2d` with `-val` raises `NotImplementedError`: the JAX CLI's validation
runs the 3D sliding window with the 2D patch and fails there too.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np

NUM_WORKERS = 4  # augmenter threads per generator


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("network", help="e.g. 3d_fullres")
    ap.add_argument("network_trainer",
                    help="d_lka_former_trainer_synapse | _acdc")
    ap.add_argument("task", help="task id or name")
    ap.add_argument("fold", help="0-4 or 'all'")
    ap.add_argument("-val", "--validation_only", action="store_true")
    ap.add_argument("-c", "--continue_training", action="store_true")
    ap.add_argument("--trans_block",
                    default="TransformerBlock_3D_single_deform_LKA")
    ap.add_argument("--depths", type=int, default=3)
    ap.add_argument("--skip_connections", type=int, default=4)
    ap.add_argument("--plans_file", default=None)
    ap.add_argument("--preprocessed_folder", default=None)
    ap.add_argument("--output_folder", default=None)
    ap.add_argument("--max_epochs", type=int, default=1000)
    ap.add_argument("--patch_size", type=int, nargs=3, default=None,
                    help="override the task patch (upstream default: "
                         "64 128 128 Synapse / 16 160 160 ACDC) — for "
                         "small datasets and smoke runs")
    ap.add_argument("--num_classes", type=int, default=None)
    ap.add_argument("--batch_size", type=int, default=2)
    ap.add_argument("--batches_per_epoch", type=int, default=250)
    ap.add_argument("--val_batches_per_epoch", type=int, default=50)
    ap.add_argument("--no_remat", action="store_true",
                    help="disable per-block gradient rematerialisation")
    ap.add_argument("--da", default="moreDA",
                    choices=["moreDA", "insaneDA", "noDA"],
                    help="augmentation pipeline variant "
                         "(data_augmentation_{moreDA,insaneDA,noDA})")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains: cuda (default) or cpu")
    return ap.parse_args(argv)


DS_SCALES_2D = [[1, 1], [0.5, 0.5], [0.25, 0.25]]  # GenericUNet's heads


def deep_supervision_scales(stem):
    """The DS targets' scales: the model's heads are at the patch, at
    patch/stem (out2, on dec1) and at patch/(2·stem) (out3, on dec2)."""
    return [[1, 1, 1], [1 / s for s in stem], [1 / (2 * s) for s in stem]]


def make_pipeline(dataset, patch, batch_size, seed, train, da="moreDA",
                  ds_scales=None):
    """(loader, transform) of one generator: `DataLoader3D` (a 2D patch:
    `DataLoader2D`) at the enlarged patch (±30° rotations, scaling
    0.7-1.4) for training, at the patch for validation, and the `da`
    augmentation (validation: no mirroring, rotation, scaling, elastic or
    intensity change; 2D: never the channel axis), seeded with `seed` and
    `seed + 1`."""
    from deformablelka_tpu_torch.data.augment import (
        get_augmentation, get_patch_size)
    from deformablelka_tpu_torch.data.dataset import DataLoader2D, DataLoader3D

    rot = (-np.pi / 6, np.pi / 6)
    enlarged = get_patch_size(patch, rot, rot, rot, (0.7, 1.4))
    loader_cls = DataLoader2D if len(patch) == 2 else DataLoader3D
    loader = loader_cls(dataset, enlarged if train else patch, batch_size,
                        rng=np.random.RandomState(seed))
    overrides = ({} if train else
                 dict(do_mirror=False, p_rot=0.0, p_scale=0.0,
                      do_elastic=False, do_intensity=False))
    if len(patch) == 2:
        overrides["mirror_axes"] = (0, 1)  # data is (B, H, W, C)
    aug = get_augmentation(da if train else "moreDA", patch,
                           deep_supervision_scales=ds_scales,
                           rng=np.random.RandomState(seed + 1), **overrides)
    return loader, lambda b: aug({"data": b["data"], "seg": b["seg"]})


def split_cases(dataset):
    """(train, validation) case dicts: upstream's hardcoded 18/12 Synapse
    split for 30 cases (d_lka_former_trainer_synapse.py:348-354), else the
    first 60 % of the sorted keys (at least one) train."""
    keys = sorted(dataset.keys())
    n_train = max(1, int(len(keys) * 0.6)) if len(keys) != 30 else 18
    train_keys, val_keys = keys[:n_train], keys[n_train:]
    return ({k: dataset[k] for k in train_keys},
            {k: dataset[k] for k in (val_keys or train_keys)})


def main(argv=None):
    args = parse_args(argv)

    from deformablelka_tpu_torch.data.augment import ThreadedAugmenter
    from deformablelka_tpu_torch.data.dataset import load_dataset, unpack_dataset
    from deformablelka_tpu_torch.models.dlka_former import (
        _build, dlka_former_acdc, dlka_former_synapse)
    from deformablelka_tpu_torch.models.generic_unet import GenericUNet
    from deformablelka_tpu_torch.training.trainer3d import Trainer3D

    is_2d = args.network == "2d"
    if is_2d and args.validation_only:
        raise NotImplementedError(
            "network '2d' with -val: the validation's sliding window is 3D; "
            "the JAX package's CLI fails on this combination as well")
    is_acdc = "acdc" in args.network_trainer
    num_classes = args.num_classes or (4 if is_acdc else 14)
    if is_2d:
        # nnUNet's `2d` configuration: GenericUNet on random slices
        patch = tuple(args.patch_size)[-2:] if args.patch_size else (256, 256)
        model = _build(GenericUNet(num_classes, ndim=2, num_pool=5, do_ds=True),
                       0, args.device)
    else:
        patch = tuple(args.patch_size) if args.patch_size else (
            (16, 160, 160) if is_acdc else (64, 128, 128))
        make_model = dlka_former_acdc if is_acdc else dlka_former_synapse
        # remat: recompute each block's forward in the backward pass
        # instead of keeping its activations (one extra forward per step)
        model = make_model(num_classes, do_ds=True, img_size=patch,
                           remat=not args.no_remat, trans_block=args.trans_block,
                           device=args.device)

    # upstream's paths.py: the folders from the environment by default
    pre_folder = (args.preprocessed_folder
                  or os.environ.get("d_lka_former_preprocessed"))
    if not pre_folder:
        raise SystemExit("set --preprocessed_folder or d_lka_former_preprocessed")
    out_folder = (Path(args.output_folder
                       or os.environ.get("RESULTS_FOLDER", "./results"))
                  / args.network_trainer / f"fold_{args.fold}")
    unpack_dataset(pre_folder)
    tr_ds, vl_ds = split_cases(load_dataset(pre_folder))
    ds_scales = (DS_SCALES_2D if is_2d else
                 deep_supervision_scales((1, 4, 4) if is_acdc else (2, 4, 4)))

    def make_gen(ds, seed, train):
        loader, transform = make_pipeline(ds, patch, args.batch_size, seed,
                                          train, args.da, ds_scales)
        return ThreadedAugmenter(loader, transform, num_workers=NUM_WORKERS)

    trainer = Trainer3D(model, out_folder,
                        make_gen(tr_ds, 1234, True),
                        make_gen(vl_ds, 5678, False),
                        max_num_epochs=args.max_epochs,
                        num_batches_per_epoch=args.batches_per_epoch,
                        num_val_batches_per_epoch=args.val_batches_per_epoch)
    try:
        if args.continue_training and trainer.ckpt.exists("model_latest"):
            trainer.initialize()
            trainer.load_checkpoint("model_latest")
        if not args.validation_only:
            trainer.run_training()
        else:
            # -val (run_training.py:202-207 → Trainer_synapse.validate):
            # load the final checkpoint, sliding-window predict every val
            # case, aggregate dice/HD95 to validation/summary.json, decide
            # largest-CC postprocessing
            validate(trainer, vl_ds, patch, num_classes, out_folder)
    finally:
        trainer.train_gen.stop()
        trainer.val_gen.stop()
    return trainer


def validate(trainer, val_dataset, patch, num_classes, out_folder):
    """Predict every validation case from the final (else best, else
    latest) checkpoint; write `<case>.npz` labels, `summary.json` and
    `postprocessing.json` under `out_folder/validation`."""
    import time

    import torch

    from deformablelka_tpu_torch.data.dataset import load_case
    from deformablelka_tpu_torch.evaluation.evaluator import aggregate_scores
    from deformablelka_tpu_torch.evaluation.postprocessing import (
        determine_postprocessing)
    from deformablelka_tpu_torch.inference.predictor3d import TTA_BATCH
    from deformablelka_tpu_torch.inference.sliding_window import (
        SlidingWindowInference)

    trainer.initialize()
    for name in ("model_final_checkpoint", "model_best", "model_latest"):
        if trainer.ckpt.exists(name):
            trainer.load_checkpoint(name)
            trainer.print_to_log_file(f"validating with {name}")
            break
    model = trainer.model.eval()

    def apply_fn(x):
        out = model(x)
        return out[0] if isinstance(out, (list, tuple)) else out

    sw = SlidingWindowInference(apply_fn, patch_size=patch,
                                num_classes=num_classes, step_size=0.5,
                                do_mirroring=True, tta_batch=TTA_BATCH,
                                device=trainer.device)
    val_dir = Path(out_folder) / "validation"
    val_dir.mkdir(parents=True, exist_ok=True)
    pairs = []
    for case in sorted(val_dataset.keys()):
        data, _ = load_case(val_dataset[case])
        data = np.asarray(data)
        vol = np.moveaxis(np.asarray(data[:-1], np.float32), 0, -1)
        gt = data[-1].astype(np.int16)
        t0 = time.time()
        seg = sw.predict_segmentation(vol)
        if trainer.device.type == "cuda":
            torch.cuda.synchronize()
        trainer.print_to_log_file(
            f"{case}: predicted in {time.time() - t0:.1f}s")
        np.savez_compressed(val_dir / f"{case}.npz",
                            data=seg.astype(np.uint8))
        pairs.append((seg, gt))
    labels = list(range(num_classes))
    summary = aggregate_scores(pairs, labels,
                               json_output_file=val_dir / "summary.json",
                               json_name=Path(out_folder).name)
    mean_fg = np.nanmean([summary["results"]["mean"][str(l)]["Dice"]
                          for l in labels[1:]])
    trainer.print_to_log_file(f"validation mean fg dice: {mean_fg:.4f}")
    determine_postprocessing(pairs, labels[1:],
                             out_json=val_dir / "postprocessing.json")
    return summary


if __name__ == "__main__":
    main()
