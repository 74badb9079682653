"""The 2D model registry: one name per network of the paper's 2D
ablations, as `--model` of the 2D CLIs names them.

Port of `deformablelka_tpu/models/registry.py`. `build_model_2d(name,
num_classes, img_size, seed, device)` returns the model with random
weights from `seed`, in eval mode (the JAX package builds every registry
model with running batch statistics and `deterministic=True`, and its
`Trainer2D` never updates a statistic), on `device`. Every model maps
(B, H, W, 1 | 3) to (B, H, W, num_classes) logits: TransUNet is built
with `apply_sigmoid=False`. The zoo's widths and geometry are upstream's
(224², as the JAX registry builds them); `img_size` reaches the models
that take it.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from deformablelka_tpu_torch.nn.layers import init_parameters


def _maxvit_dlka(num_classes, img_size):
    from deformablelka_tpu_torch.models.maxvit_dlka import MaxViTDeformableLKAFormer
    return MaxViTDeformableLKAFormer(num_classes, img_size, deformable=True)


def _maxvit_lka(num_classes, img_size):
    from deformablelka_tpu_torch.models.maxvit_dlka import MaxViTDeformableLKAFormer
    return MaxViTDeformableLKAFormer(num_classes, img_size, deformable=False)


def _daeformer(num_classes, img_size):
    from deformablelka_tpu_torch.models.daeformer import DAEFormer
    return DAEFormer(num_classes)


def _dae_lka(num_classes, img_size):
    from deformablelka_tpu_torch.models.dae_lka import DAELKAFormer
    return DAELKAFormer(num_classes)


def _mvit_lka(num_classes, img_size):
    from deformablelka_tpu_torch.models.mvit import MViTLKAFormer
    return MViTLKAFormer(num_classes, img_size)


def _dat_lka(num_classes, img_size):
    from deformablelka_tpu_torch.models.dat_lka import DATLKAFormer
    return DATLKAFormer(num_classes)


def _swinunet(num_classes, img_size):
    from deformablelka_tpu_torch.models.swinunet import SwinUNet
    return SwinUNet(num_classes, img_size)


def _segformer(num_classes, img_size):
    from deformablelka_tpu_torch.nn.segformer import SegFormer
    return SegFormer(num_classes)


def _stvit_lka(num_classes, img_size):
    from deformablelka_tpu_torch.models.stvit import STVitLKA
    return STVitLKA(num_classes)


def _semantic_stvit(num_classes, img_size):
    from deformablelka_tpu_torch.models.stvit import SemanticSTViT
    return SemanticSTViT(num_classes)


def _bidaeformer(num_classes, img_size):
    from deformablelka_tpu_torch.models.biformer import BiDAEFormer
    return BiDAEFormer(num_classes)


def _transunet(num_classes, img_size):
    from deformablelka_tpu_torch.models.transunet import TransUNet
    return TransUNet(num_classes, img_size, apply_sigmoid=False)


def _hiformer(num_classes, img_size):
    from deformablelka_tpu_torch.models.hiformer import HiFormer
    return HiFormer(num_classes, img_size)


MODELS_2D: Dict[str, Callable] = {
    # the flagship and the paper's ablations (upstream's 2D/networks/)
    "maxvit_deform_lka": _maxvit_dlka,   # MaxViT_deform_LKA.py
    "maxvit_lka": _maxvit_lka,           # MaxViT_LKA_Decoder.py
    "daeformer": _daeformer,             # DAEFormer.py
    "dae_lka": _dae_lka,                 # DAEEncoder_LKADecoder.py
    "mvit_lka": _mvit_lka,               # mvit_LKA_Decoder.py
    "dat_lka": _dat_lka,                 # DAT_LKA_Decoder.py
    "stvit_lka": _stvit_lka,             # STViTEncoder_LKADecoder.py
    "semantic_stvit": _semantic_stvit,   # STViTSegmentation.py
    "bidaeformer": _bidaeformer,         # BiEncoderDAEDecoder.py
    "swinunet": _swinunet,               # swinunet.py
    "segformer": _segformer,             # segformer.py
    # the skin baselines (upstream's 2D/skin_code/model/)
    "transunet": _transunet,             # vit_seg_modeling.py
    "hiformer": _hiformer,               # hiformer/
}


def build_model_2d(name: str, num_classes: int = 9, img_size: int = 224, seed: int = 0,
                   device="cuda"):
    """The registry's model `name` with random weights from `seed`, in eval
    mode, on `device`. An unknown name raises ValueError."""
    try:
        factory = MODELS_2D[name]
    except KeyError:
        raise ValueError(f"unknown 2D model {name!r}; choose from {sorted(MODELS_2D)}") from None
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
    model = factory(num_classes, img_size)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
