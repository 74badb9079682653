"""2D Synapse evaluation CLI (the port's
`deformablelka_tpu/cli/test_synapse2d.py`).

Mirrors upstream's 2D/test.py:19-140: load the trained checkpoint, run
the slice-loop inference over test_vol.txt's h5 volumes, report per-case
and mean Dice/HD95, optionally write NIfTI predictions:

    python -m deformablelka_tpu_torch.cli.test_synapse2d --volume_path VOL
        --list_dir LISTS --output_dir OUT [--checkpoint best_model]
        [--no_deform | --model NAME] [--is_savenii --test_save_dir DIR]
        [--device cuda|cpu]

`OUT/ckpt/<checkpoint>` is a `torch.save` checkpoint of
`training/trainer2d.Trainer2D` ({"model": state_dict}). Runs on the card
unless `--device cpu`, in float32; the h5 volumes need h5py
(`evaluate_volumes` takes volumes already in memory). `--model` names the
2D zoo's network the checkpoint was trained with (`models/registry.py`);
an unknown name raises ValueError.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--volume_path", required=True,
                    help="dir with <case>.npy.h5 volumes")
    ap.add_argument("--list_dir", required=True)
    ap.add_argument("--output_dir", required=True,
                    help="training output dir holding ckpt/")
    ap.add_argument("--checkpoint", default="best_model")
    ap.add_argument("--num_classes", type=int, default=9)
    ap.add_argument("--img_size", type=int, default=224)
    ap.add_argument("--is_savenii", action="store_true")
    ap.add_argument("--test_save_dir", default="./predictions")
    ap.add_argument("--no_deform", action="store_true")
    ap.add_argument("--model", default=None,
                    help="registry name of the ablation model the checkpoint was "
                         "trained with (models/registry.py)")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda (default) or cpu")
    return ap.parse_args(argv)


def build_model(model, num_classes, img_size, no_deform=False, seed=0, device="cuda"):
    """The registry's `model` if one is named, else the flagship
    (`no_deform`: its LKA Baseline), with random weights from `seed`."""
    from deformablelka_tpu_torch.models import registry

    if model is None:
        model = "maxvit_lka" if no_deform else "maxvit_deform_lka"
    return registry.build_model_2d(model, num_classes, img_size, seed, device)


def evaluate_volumes(predictor, cases, save_dir=None) -> list:
    """Per case of `cases`, (image (S, H, W), label (S, H, W), name)
    triples: `predictor.evaluate_case`, a line with its mean Dice and
    HD95 over the classes, and its labels written as `<name>_pred.nii.gz`
    under `save_dir` if given. Returns [(name, mean dice, mean hd95,
    labels)]."""
    out = []
    for image, label, name in cases:
        pred, per_class = predictor.evaluate_case(image, label)
        md = float(np.mean([d for d, _ in per_class]))
        mh = float(np.mean([h for _, h in per_class]))
        print(f"{name}: mean_dice {md:.4f} mean_hd95 {mh:.2f}")
        if save_dir is not None:
            from deformablelka_tpu_torch.data import nifti
            Path(save_dir).mkdir(parents=True, exist_ok=True)
            nifti.save(pred.astype(np.float32), Path(save_dir) / f"{name}_pred.nii.gz")
        out.append((name, md, mh, pred))
    return out


def load_predictor(output_dir, checkpoint="best_model", num_classes=9, img_size=224,
                   no_deform=False, device="cuda", model=None):
    """The `Predictor2D` of the weights in `<output_dir>/ckpt/<checkpoint>`
    for the flagship, its LKA Baseline or the registry's `model`."""
    from deformablelka_tpu_torch.inference.predictor2d import Predictor2D
    from deformablelka_tpu_torch.training.checkpoint import CheckpointManager

    model = build_model(model, num_classes, img_size, no_deform, device=device)
    state, _ = CheckpointManager(Path(output_dir) / "ckpt").load(checkpoint)
    model.load_state_dict(state["model"], strict=True)
    return Predictor2D(model, (img_size, img_size), num_classes, device=device)


def main(argv=None):
    args = parse_args(argv)

    from deformablelka_tpu_torch.data.synapse2d import SynapseDataset2D

    predictor = load_predictor(args.output_dir, args.checkpoint, args.num_classes,
                               args.img_size, args.no_deform, args.device, args.model)
    ds = SynapseDataset2D(args.volume_path, args.list_dir, "test_vol",
                          img_size=args.img_size)
    cases = ((s["image"], s["label"], s["case_name"])
             for s in map(ds.get, range(len(ds))))
    per_case = evaluate_volumes(predictor, cases,
                                args.test_save_dir if args.is_savenii else None)
    md = float(np.mean([d for _, d, _, _ in per_case]))
    mh = float(np.mean([h for _, _, h, _ in per_case]))
    print(f"Testing performance: mean_dice {md:.4f} mean_hd95 {mh:.2f}")
    return per_case


if __name__ == "__main__":
    main()
