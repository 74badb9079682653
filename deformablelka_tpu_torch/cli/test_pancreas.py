"""NIH-Pancreas evaluation CLI (the port's
`deformablelka_tpu/cli/test_pancreas.py`).

Mirrors upstream's pancreas_code/test_pancreas.py:14-70: load the
checkpoint (a checkpoint of the port's `training/checkpoint.py` in
`--model_dir`, the model's state_dict under "model"), run stride-16
sliding-window inference over the test fold (h5 cases, which need h5py),
report mean (dice, jaccard, hd95, asd):

    python -m deformablelka_tpu_torch.cli.test_pancreas --root_path BASE
        --model_dir RUN [--checkpoint d_lka_former_iter_6000]
        [--model dlka_net|vnet|resnet34|unetr]
        [--device cuda|cpu]

The model runs in float32 on the card unless `--device cpu`. The JAX CLI
casts the input to bfloat16 before the model; the port's kernels take
float32 only, so the port does not.
"""

from __future__ import annotations

import argparse

from deformablelka_tpu_torch.cli._pancreas_models import BASELINES


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root_path", required=True)
    ap.add_argument("--model_dir", required=True,
                    help="dir holding the checkpoint")
    ap.add_argument("--checkpoint", default="d_lka_former_iter_6000")
    ap.add_argument("--test_fold", default="test0.list")
    ap.add_argument("--save_dir", default=None)
    ap.add_argument("--patch_size", type=int, nargs=3, default=[96, 96, 96])
    ap.add_argument("--stride_xy", type=int, default=16)
    ap.add_argument("--stride_z", type=int, default=16)
    ap.add_argument("--trans_block",
                    default="TransformerBlock_3D_single_deform_LKA")
    ap.add_argument("--model", default="dlka_net",
                    choices=["dlka_net", *BASELINES],
                    help="network: D-LKA Net or a baseline (vnet, "
                         "resnet34/resseg3d, unetr/unetr_mini)")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from deformablelka_tpu_torch.cli._pancreas_models import build_pancreas_model
    from deformablelka_tpu_torch.data.pancreas import read_fold_list
    from deformablelka_tpu_torch.inference.pancreas import (
        make_pancreas_sliding_window, test_all_case)
    from deformablelka_tpu_torch.training.checkpoint import CheckpointManager

    model = build_pancreas_model(args.model, args.trans_block,
                                 tuple(args.patch_size), device=args.device)
    state, _ = CheckpointManager(args.model_dir).load(args.checkpoint)
    model.load_state_dict(state["model"], strict=True)
    sw = make_pancreas_sliding_window(
        model.eval(), patch_size=tuple(args.patch_size),
        stride_xy=args.stride_xy, stride_z=args.stride_z, device=args.device)
    cases = read_fold_list(args.root_path, args.test_fold)
    avg = test_all_case(sw, cases, save_dir=args.save_dir)
    print(f"dice={avg[0]:.4f} jaccard={avg[1]:.4f} "
          f"hd95={avg[2]:.2f} asd={avg[3]:.2f}")
    return avg


if __name__ == "__main__":
    main()
