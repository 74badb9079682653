"""NIH-Pancreas training CLI (the port's
`deformablelka_tpu/cli/train_pancreas.py`).

Mirrors upstream's pancreas_code/train_pancreas.py:25-41 (argparse
surface) and :93-191 (engine wiring): D_LKA_Net 96³ from `--seed`, h5 fold
lists (h5py needed), random-crop batches of `--batch_size` with the loss
on the first `--labeled_bs`, 6000 iterations, the checkpoint
`<output_dir>/<exp>/d_lka_former_iter_<N>`:

    python -m deformablelka_tpu_torch.cli.train_pancreas --root_path BASE
        [--output_dir ./model] [--max_iterations 6000] [--device cuda|cpu]

Trains on the card unless `--device cpu`, in float32. `--model vnet`,
`resnet34` (`resseg3d`) or `unetr` (`unetr_mini`) trains a Pancreas
baseline instead (`cli/_pancreas_models.py`).
"""

from __future__ import annotations

import argparse

from deformablelka_tpu_torch.cli._pancreas_models import BASELINES


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root_path", required=True,
                    help="dataset base dir (holds Pancreas/Flods/*.list)")
    ap.add_argument("--exp", default="pancreas_dlka", help="experiment name")
    ap.add_argument("--output_dir", default="./model")
    ap.add_argument("--max_iterations", type=int, default=6000)
    ap.add_argument("--batch_size", type=int, default=2)
    ap.add_argument("--labeled_bs", type=int, default=1)
    ap.add_argument("--base_lr", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=1337)
    ap.add_argument("--train_fold", default="train0.list")
    ap.add_argument("--patch_size", type=int, nargs=3, default=[96, 96, 96])
    ap.add_argument("--trans_block",
                    default="TransformerBlock_3D_single_deform_LKA")
    ap.add_argument("--model", default="dlka_net",
                    choices=["dlka_net", *BASELINES],
                    help="network: D-LKA Net or a baseline (vnet, "
                         "resnet34/resseg3d, unetr/unetr_mini)")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains: cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from deformablelka_tpu_torch.cli._pancreas_models import build_pancreas_model
    from deformablelka_tpu_torch.data.pancreas import (
        PancreasDataLoader, read_fold_list)
    from deformablelka_tpu_torch.training.trainer_pancreas import TrainerPancreas

    model = build_pancreas_model(args.model, args.trans_block,
                                 tuple(args.patch_size), device=args.device,
                                 seed=args.seed)
    cases = read_fold_list(args.root_path, args.train_fold)
    loader = PancreasDataLoader(cases, crop_size=tuple(args.patch_size),
                                batch_size=args.batch_size, seed=args.seed)
    trainer = TrainerPancreas(
        model, out_dir=f"{args.output_dir}/{args.exp}",
        base_lr=args.base_lr, max_iterations=args.max_iterations,
        batch_size=args.batch_size, labeled_bs=args.labeled_bs)
    trainer.run_training(loader)
    return trainer


if __name__ == "__main__":
    main()
