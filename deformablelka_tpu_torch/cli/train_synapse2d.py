"""2D Synapse training CLI (the port's
`deformablelka_tpu/cli/train_synapse2d.py`).

Mirrors upstream's 2D/train_MaxViT_deform_LKA.py:20-127 (argparse
surface, seeding, model build) and trainer_MaxViT_deform_LKA.py:72-213
(SGD momentum 0.9 wd 1e-4, 0.4·CE + 0.6·Dice, per-iteration poly LR,
eval every eval_interval epochs after half the run):

    python -m deformablelka_tpu_torch.cli.train_synapse2d --root_path NPZ
        --list_dir LISTS [--volume_path VOL] [--output_dir ./model_out]
        [--no_deform] [--pretrained_backbone timm.pth] [--device cuda|cpu]

trains the MaxViT D-LKA Net (`--no_deform`: the LKA Baseline), built from
`--seed`, with `training/trainer2d.Trainer2D` on the npz slices of
`train.txt`; with `--volume_path` the eval hook predicts test_vol.txt's
h5 volumes and prints their mean Dice. Runs on the card unless `--device
cpu`, in float32. `main` returns the trainer. The 2D ablation zoo
(`--model`) is not ported yet and raises.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root_path", required=True,
                    help="dir with per-slice npz files")
    ap.add_argument("--list_dir", required=True,
                    help="dir with train.txt / test_vol.txt")
    ap.add_argument("--volume_path", default=None,
                    help="dir with test .npy.h5 volumes (for eval hook)")
    ap.add_argument("--output_dir", default="./model_out")
    ap.add_argument("--num_classes", type=int, default=9)
    ap.add_argument("--max_epochs", type=int, default=400)
    ap.add_argument("--batch_size", type=int, default=24)
    ap.add_argument("--base_lr", type=float, default=0.05)
    ap.add_argument("--img_size", type=int, default=224)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--eval_interval", type=int, default=20)
    ap.add_argument("--no_deform", action="store_true",
                    help="train the LKA baseline decoder")
    ap.add_argument("--model", default=None,
                    help="registry name of an ablation model (not ported yet: raises)")
    ap.add_argument("--pretrained_backbone", default=None,
                    help="timm MaxViT .pth to warm-start the encoder")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains: cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None, eval_cases=None):
    """`eval_cases`, a sequence of (image, label, name) volumes, stands in
    for `--volume_path`'s h5 files in the eval hook."""
    args = parse_args(argv)

    from deformablelka_tpu_torch.cli.test_synapse2d import evaluate_volumes, zoo_not_ported

    if args.model:
        raise zoo_not_ported(args.model)

    import numpy as np

    from deformablelka_tpu_torch.convert.backbone import load_maxvit_backbone
    from deformablelka_tpu_torch.data.synapse2d import SynapseDataset2D, SynapseLoader2D
    from deformablelka_tpu_torch.inference.predictor2d import Predictor2D
    from deformablelka_tpu_torch.models.maxvit_dlka import (maxvit_dlka_former,
                                                            maxvit_lka_former)
    from deformablelka_tpu_torch.training.trainer2d import Trainer2D

    np.random.seed(args.seed)
    ds = SynapseDataset2D(args.root_path, args.list_dir, "train",
                          img_size=args.img_size, seed=args.seed,
                          num_classes=args.num_classes)
    loader = SynapseLoader2D(ds, args.batch_size)
    factory = maxvit_lka_former if args.no_deform else maxvit_dlka_former
    model = factory(args.num_classes, img_size=args.img_size, seed=args.seed,
                    device=args.device)

    if eval_cases is None and args.volume_path:
        vol_ds = SynapseDataset2D(args.volume_path, args.list_dir, "test_vol",
                                  img_size=args.img_size)
        eval_cases = [(s["image"], s["label"], s["case_name"])
                      for s in map(vol_ds.get, range(len(vol_ds)))]
    eval_hook = None
    if eval_cases is not None:
        def eval_hook(trainer):
            pred = Predictor2D(trainer.model, (args.img_size, args.img_size),
                               args.num_classes, device=args.device)
            dice = float(np.mean([d for _, d, _, _ in evaluate_volumes(pred, eval_cases)]))
            print(f"eval epoch {trainer.epoch}: mean dice {dice:.4f}")
            return dice

    # the tensorboardX log dir mirrors upstream's
    # SummaryWriter(snapshot_path + '/log') (trainer_MaxViT_deform_LKA.py:116)
    trainer = Trainer2D(model, args.output_dir, loader,
                        base_lr=args.base_lr, max_epochs=args.max_epochs,
                        iterations_per_epoch=loader.num_batches,
                        eval_hook=eval_hook,
                        eval_interval=args.eval_interval,
                        tensorboard_dir=str(Path(args.output_dir) / "log"))
    if args.pretrained_backbone:
        trainer.initialize(loader.next())
        load_maxvit_backbone(model, args.pretrained_backbone)
    trainer.run_training()
    return trainer


if __name__ == "__main__":
    main()
