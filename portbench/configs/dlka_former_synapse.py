"""The program's 3D D-LKA Former at the sizes of
`dlka_former_synapse.json`, built through the port's own entry point."""

from __future__ import annotations


def build(cfg: dict, device, remat: bool = False):
    from deformablelka_tpu_torch.models.dlka_former import dlka_former_synapse

    return dlka_former_synapse(cfg["num_classes"], do_ds=cfg["do_ds"],
                               img_size=tuple(cfg["img_size"]), remat=remat,
                               device=device)
