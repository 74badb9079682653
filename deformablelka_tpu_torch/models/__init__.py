"""The port's model factories: the 3D D-LKA Former's Synapse, ACDC and
Pancreas configurations, the 2D MaxViT D-LKA Net's flagship and LKA
Baseline, the 2D ablation zoo behind `registry.build_model_2d`, the
Pancreas baselines (VNet, the ResNet34 seg net, UNETR), nnUNet's
GenericUNet and Swin UNETR's BTCV configuration. A restore manifest (`inference/model_restore.py`) names one
of these."""

from deformablelka_tpu_torch.models.biformer import BiDAEFormer, BiFormer3Out
from deformablelka_tpu_torch.models.dae_lka import DAELKAFormer
from deformablelka_tpu_torch.models.daeformer import DAEFormer
from deformablelka_tpu_torch.models.dat_lka import DATLKAFormer
from deformablelka_tpu_torch.models.dlka_former import (
    DLKAFormer,
    dlka_former_acdc,
    dlka_former_synapse,
    dlka_net_pancreas,
)
from deformablelka_tpu_torch.models.generic_unet import (
    GenericUNet,
    generic_unet_3d_from_plans,
)
from deformablelka_tpu_torch.models.hiformer import HiFormer
from deformablelka_tpu_torch.models.maxvit_dlka import (
    MaxViTDeformableLKAFormer,
    maxvit_dlka_former,
    maxvit_lka_former,
)
from deformablelka_tpu_torch.models.mvit import MViT4Out, MViTLKAFormer
from deformablelka_tpu_torch.models.pancreas_baselines import UNETR, Resnet34Seg, VNet
from deformablelka_tpu_torch.models.registry import MODELS_2D, build_model_2d
from deformablelka_tpu_torch.models.stvit import SemanticSTViT, STViT4Out, STVitLKA
from deformablelka_tpu_torch.models.swin_unetr import SwinUNETR, swin_unetr_btcv
from deformablelka_tpu_torch.models.swinunet import SwinUNet
from deformablelka_tpu_torch.models.transunet import TransUNet
from deformablelka_tpu_torch.nn.segformer import SegFormer

__all__ = ["DLKAFormer", "dlka_former_acdc", "dlka_former_synapse",
           "dlka_net_pancreas", "MaxViTDeformableLKAFormer",
           "maxvit_dlka_former", "maxvit_lka_former", "MODELS_2D", "build_model_2d",
           "DAEFormer", "DAELKAFormer", "MViT4Out", "MViTLKAFormer", "DATLKAFormer",
           "SwinUNet", "SegFormer", "STViT4Out", "STVitLKA", "SemanticSTViT",
           "BiFormer3Out", "BiDAEFormer", "TransUNet", "HiFormer", "GenericUNet",
           "generic_unet_3d_from_plans", "VNet", "Resnet34Seg", "UNETR", "SwinUNETR",
           "swin_unetr_btcv"]
