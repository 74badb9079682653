"""The program's 2D MaxViT D-LKA Net at the sizes of
`maxvit_dlka_synapse2d.json`, built through the port's own entry point."""

from __future__ import annotations


def build(cfg: dict, device):
    from deformablelka_tpu_torch.models.maxvit_dlka import maxvit_dlka_former

    return maxvit_dlka_former(cfg["num_classes"], img_size=cfg["img_size"], device=device)
