"""The port's model factories: the 3D D-LKA Former's Synapse, ACDC and
Pancreas configurations and the 2D MaxViT D-LKA Net's flagship and LKA
Baseline. A restore manifest (`inference/model_restore.py`) names one of
these."""

from deformablelka_tpu_torch.models.dlka_former import (
    DLKAFormer,
    dlka_former_acdc,
    dlka_former_synapse,
    dlka_net_pancreas,
)
from deformablelka_tpu_torch.models.maxvit_dlka import (
    MaxViTDeformableLKAFormer,
    maxvit_dlka_former,
    maxvit_lka_former,
)

__all__ = ["DLKAFormer", "dlka_former_acdc", "dlka_former_synapse",
           "dlka_net_pancreas", "MaxViTDeformableLKAFormer",
           "maxvit_dlka_former", "maxvit_lka_former"]
