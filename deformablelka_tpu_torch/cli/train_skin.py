"""Skin-lesion training CLI (ISIC 2017/2018, PH2; the port's
`deformablelka_tpu/cli/train_skin.py`).

Mirrors upstream's 2D/skin_code/train_skin_2017.py:25-152: the npy data
dir from Prepare_*.py, the MaxViT D-LKA Net with num_classes=1 on RGB
input, BCE loss, SGD + ReduceLROnPlateau, the best-validation-loss
checkpoint; with `--evaluate`, evaluate_skin.ipynb on the test split
from that checkpoint:

    python -m deformablelka_tpu_torch.cli.train_skin --root_path NPY
        [--output_dir ./model_skin] [--batch_size 16] [--max_epochs 100]
        [--no_deform] [--evaluate] [--device cuda|cpu]

Runs on the card unless `--device cpu`, in float32. `main` returns the
trainer, with the test metrics in `trainer.test_metrics` after
`--evaluate`. The skin baselines (`--model`) are not ported yet and
raise.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root_path", required=True,
                    help="dir with data_/mask_{train,val,test}.npy")
    ap.add_argument("--output_dir", default="./model_skin")
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--max_epochs", type=int, default=100)
    ap.add_argument("--base_lr", type=float, default=1e-3)
    ap.add_argument("--img_size", type=int, default=224)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--no_deform", action="store_true",
                    help="LKA baseline decoder")
    ap.add_argument("--model", default=None,
                    help="skin baseline from the 2D zoo (not ported yet: raises)")
    ap.add_argument("--evaluate", action="store_true",
                    help="after training, evaluate best_model on the test split")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains: cuda (default) or cpu")
    return ap.parse_args(argv)


def evaluate_best_model(trainer, root_path, device) -> dict:
    """evaluate_skin.ipynb on `root_path`'s test split with the weights of
    the trainer's `best_model`: the sigmoid of the logits, threshold 0.5,
    opening and hole filling of size 6, pooled pixel metrics."""
    import torch

    from deformablelka_tpu_torch.data.skin import ISICLoader
    from deformablelka_tpu_torch.evaluation.skin_eval import evaluate_skin_model

    state, _ = trainer.ckpt.load("best_model")
    trainer.model.load_state_dict(state["model"], strict=True)
    test = ISICLoader(root_path, "test", batch_size=1)
    items = ({"image": b["image"][0], "mask": b["mask"][0, ..., 0]} for b in test.epoch())
    return evaluate_skin_model(lambda x: torch.sigmoid(trainer.model(x)), items,
                               device=device)


def main(argv=None):
    args = parse_args(argv)
    if args.model:
        raise NotImplementedError(
            f"--model {args.model}: the skin baselines of the 2D zoo are not ported to "
            "deformablelka_tpu_torch yet (ROADMAP Queue 1 item 6)")

    from deformablelka_tpu_torch.data.skin import ISICLoader
    from deformablelka_tpu_torch.models.maxvit_dlka import (maxvit_dlka_former,
                                                            maxvit_lka_former)
    from deformablelka_tpu_torch.training.trainer2d import TrainerSkin

    train_loader = ISICLoader(args.root_path, "train",
                              batch_size=args.batch_size, seed=args.seed)
    val_loader = ISICLoader(args.root_path, "val", batch_size=1)
    factory = maxvit_lka_former if args.no_deform else maxvit_dlka_former
    model = factory(1, img_size=args.img_size, seed=args.seed, device=args.device)
    trainer = TrainerSkin(model, args.output_dir, base_lr=args.base_lr,
                          max_epochs=args.max_epochs)
    trainer.run_training(train_loader, val_loader)
    print(f"best val loss: {trainer.best_val_loss:.4f}")
    if args.evaluate:
        trainer.test_metrics = evaluate_best_model(trainer, args.root_path, args.device)
        best = trainer.test_metrics["best"]
        print("test: " + ", ".join(f"{k} {best[k]:.4f}" for k in
                                   ("dsc", "accuracy", "specificity", "sensitivity")))
    return trainer


if __name__ == "__main__":
    main()
