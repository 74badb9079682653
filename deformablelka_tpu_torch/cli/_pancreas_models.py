"""Pancreas model registry for the train and test CLIs (the port's copy of
`deformablelka_tpu/cli/_pancreas_models.py`).

Upstream hardcodes D_LKA_Net in train_pancreas.py and keeps the baselines
(vnet.py, ResNet34.py, unetr.py) as separate files the user swaps in by
editing code; the JAX package makes them one `--model` axis. The port has
D-LKA Net; the baselines are not ported yet.
"""

from __future__ import annotations

BASELINES = ("vnet", "resnet34", "resseg3d", "unetr", "unetr_mini")


def build_pancreas_model(name: str, trans_block: str, patch_size, device="cuda",
                         seed: int = 0):
    if name == "dlka_net":
        from deformablelka_tpu_torch.models.dlka_former import dlka_net_pancreas
        return dlka_net_pancreas(trans_block=trans_block,
                                 img_size=tuple(patch_size), seed=seed,
                                 device=device)
    if name in BASELINES:
        raise NotImplementedError(
            f"pancreas model {name!r}: the Pancreas baselines (VNet, ResNet34, "
            "UNETR) are not ported to deformablelka_tpu_torch yet; only "
            "'dlka_net' is")
    raise KeyError(f"unknown pancreas model {name!r}")
