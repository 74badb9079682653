"""Pancreas model registry for the train and test CLIs (the port's copy of
`deformablelka_tpu/cli/_pancreas_models.py`).

Upstream hardcodes D_LKA_Net in train_pancreas.py and keeps the baselines
(vnet.py, ResNet34.py, unetr.py) as separate files the user swaps in by
editing code; the JAX package makes them one `--model` axis, and so does
the port: `dlka_net`, `vnet`, `resnet34` (alias `resseg3d`) and `unetr`
(alias `unetr_mini`), each with random weights from `seed`, in eval mode,
on `device`.
"""

from __future__ import annotations

BASELINES = ("vnet", "resnet34", "resseg3d", "unetr", "unetr_mini")


def build_pancreas_model(name: str, trans_block: str, patch_size, device="cuda",
                         seed: int = 0):
    from deformablelka_tpu_torch.models.dlka_former import _build, dlka_net_pancreas
    if name == "dlka_net":
        return dlka_net_pancreas(trans_block=trans_block,
                                 img_size=tuple(patch_size), seed=seed,
                                 device=device)
    from deformablelka_tpu_torch.models.pancreas_baselines import (
        UNETR, Resnet34Seg, VNet)
    if name == "vnet":
        model = VNet(n_classes=2)
    elif name in ("resnet34", "resseg3d"):
        model = Resnet34Seg(n_classes=2)
    elif name in ("unetr", "unetr_mini"):
        model = UNETR(n_classes=2, img_size=tuple(patch_size))
    else:
        raise KeyError(f"unknown pancreas model {name!r}")
    return _build(model, seed, device)
