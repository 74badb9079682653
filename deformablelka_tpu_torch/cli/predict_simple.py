"""Batch prediction CLI (the port's `deformablelka_tpu/cli/predict_simple.py`).

Mirrors upstream's inference/predict_simple.py:33-…:

    python -m deformablelka_tpu_torch.cli.predict_simple -i INPUT_FOLDER
        -o OUTPUT_FOLDER --model_folder RUN -f 0 1
        [-chk model_final_checkpoint] [--step_size 0.5] [--disable_tta]
        [--device cuda|cpu]

Every `.nii.gz` case of INPUT_FOLDER is preprocessed to the target
spacing, predicted by `dlka_former_synapse` with each fold's weights
(`RUN/fold_<f>/ckpt/<checkpoint_name>`, a checkpoint of the port's
`training/checkpoint.py` with the model's state_dict under "model"), the
folds' probabilities averaged, restored to the case's geometry and
written as uint8 labels to OUTPUT_FOLDER. Runs on the card unless
`--device cpu`; the 8 mirror flips of a tile run as one batch-8 forward.
`main` returns the `Predictor3D` it built.
"""

from __future__ import annotations

import argparse
import copy

# the JAX CLI's CT intensity properties (dataset foreground percentiles,
# mean and sd of Synapse)
CT_INTENSITY = {0: {"percentile_00_5": -958, "percentile_99_5": 270,
                    "mean": 99.4, "sd": 77.9}}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-i", "--input_folder", required=True)
    ap.add_argument("-o", "--output_folder", required=True)
    ap.add_argument("-m", "--model", default="3d_fullres")
    ap.add_argument("-f", "--folds", nargs="+", default=["0"])
    ap.add_argument("-chk", "--checkpoint_name",
                    default="model_final_checkpoint")
    ap.add_argument("-t", "--task_name", default="Task002_Synapse")
    ap.add_argument("--model_folder", required=True,
                    help="trainer output folder containing fold_<f>/ckpt/")
    ap.add_argument("--step_size", type=float, default=0.5)
    ap.add_argument("--disable_tta", action="store_true")
    ap.add_argument("--trans_block",
                    default="TransformerBlock_3D_single_deform_LKA")
    ap.add_argument("--num_classes", type=int, default=14)
    ap.add_argument("--patch_size", type=int, nargs=3,
                    default=[64, 128, 128],
                    help="sliding-window patch (reference Synapse "
                         "default 64 128 128)")
    ap.add_argument("--norm", default="CT", choices=["CT", "nonCT"],
                    help="preprocessing normalization scheme "
                         "(preprocessing.py:276-316)")
    ap.add_argument("--target_spacing", type=float, nargs=3,
                    default=[3.0, 0.76, 0.76])
    ap.add_argument("--use_nonzero_mask", default="0", choices=["0", "1"],
                    help="normalize within the nonzero mask "
                         "(preprocessing.py:286-308); it must match the "
                         "value the training pipeline used (the plan's "
                         "use_nonzero_mask)")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from deformablelka_tpu_torch.data.preprocessing import GenericPreprocessor
    from deformablelka_tpu_torch.inference.predictor3d import (
        Predictor3D, predict_from_folder)
    from deformablelka_tpu_torch.models.dlka_former import dlka_former_synapse
    from deformablelka_tpu_torch.training.checkpoint import CheckpointManager

    patch = tuple(args.patch_size)
    model = dlka_former_synapse(num_classes=args.num_classes, do_ds=False,
                                trans_block=args.trans_block,
                                img_size=patch, device=args.device)
    models = []
    for fold in args.folds:
        ckpt = CheckpointManager(f"{args.model_folder}/fold_{fold}/ckpt")
        state, _ = ckpt.load(args.checkpoint_name)
        fold_model = copy.deepcopy(model)
        fold_model.load_state_dict(state["model"], strict=True)
        models.append(fold_model.eval())
    del model

    pre = GenericPreprocessor(
        normalization_schemes=[args.norm],
        use_nonzero_mask=[args.use_nonzero_mask == "1"],
        target_spacing=list(args.target_spacing),
        intensity_properties=CT_INTENSITY if args.norm == "CT" else None)
    predictor = Predictor3D(models, pre, patch_size=patch,
                            num_classes=args.num_classes,
                            step_size=args.step_size,
                            do_mirroring=not args.disable_tta,
                            device=args.device)
    predict_from_folder(predictor, args.input_folder, args.output_folder)
    return predictor


if __name__ == "__main__":
    main()
