"""The 2D D-LKA Net: MaxViT encoder + deformable-LKA decoder (NHWC).

Port of `deformablelka_tpu/models/maxvit_dlka.py` (upstream's
`MaxViT_deform_LKA.py:488-696`), with upstream's attribute names:
`backbone.backbone` is the MaxViT encoder; four decoders with dims (768,
384, 192, 96) at /32, /16, /8, /4. `decoder_3` is a PatchExpand only; the
others add the skip to a linear map of the input, run two LKA blocks and
expand (`decoder_0` by 4, then a 1×1 class head).

`deformable=False` is the paper's "LKA Baseline" (`MaxViT_LKA_Decoder.py`,
`maxvit_lka_former`): plain `LKABlock`s, and, as upstream does, each
decoder applies `layer_lka_1` twice and has no `layer_lka_2`. The tail
computes the function in its plain order (expand, shuffle, LayerNorm,
head); the JAX package's subpixel reordering of it is a TPU lowering.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from deformablelka_tpu_torch.models.maxvit import MaxViT4Out
from deformablelka_tpu_torch.nn.layers import Conv2d, Linear, init_parameters
from deformablelka_tpu_torch.nn.lka2d import LKABlock, deformableLKABlock
from deformablelka_tpu_torch.nn.norms import LayerNorm


class PatchExpand(nn.Module):
    """×2 pixel-shuffle upsample: Linear(C → 2C, no bias), 2×2 shuffle to
    C/2 channels, LayerNorm."""

    def __init__(self, dim: int):
        super().__init__()
        self.expand = Linear(dim, 2 * dim, bias=False)
        self.norm = LayerNorm(dim // 2)

    def forward(self, x):
        B, H, W, C = x.shape
        x = self.expand(x).reshape(B, H, W, 2, 2, C // 2)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, 2 * H, 2 * W, C // 2)
        return self.norm(x)


class FinalPatchExpand_X4(nn.Module):
    """×4 pixel-shuffle upsample keeping C: Linear(C → 16C, no bias),
    4×4 shuffle, LayerNorm."""

    def __init__(self, dim: int):
        super().__init__()
        self.expand = Linear(dim, 16 * dim, bias=False)
        self.norm = LayerNorm(dim)

    def forward(self, x):
        B, H, W, C = x.shape
        x = self.expand(x).reshape(B, H, W, 4, 4, C)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, 4 * H, 4 * W, C)
        return self.norm(x)


class DecoderLayer(nn.Module):
    """upstream's MyDecoderLayer at width `dim`. `first` (decoder_3) is a
    PatchExpand of its input only; the others take (x1, skip x2), x1 of
    width `in_dim` (default `dim`: the JAX `x1_linear` takes its input
    width from x1) and x2 of width `dim`."""

    def __init__(self, dim: int, n_class: int = 9,
                 is_last: bool = False, first: bool = False,
                 deformable: bool = True, in_dim: int | None = None):
        super().__init__()
        self.first, self.is_last = first, is_last
        self.reuse_first_lka = not deformable
        if first:
            self.layer_up = PatchExpand(dim)
            return
        block = deformableLKABlock if deformable else LKABlock
        self.x1_linear = Linear(in_dim or dim, dim)
        self.layer_lka_1 = block(dim)
        if not self.reuse_first_lka:
            self.layer_lka_2 = block(dim)
        if is_last:
            self.layer_up = FinalPatchExpand_X4(dim)
            self.last_layer = Conv2d(dim, n_class, 1)
        else:
            self.layer_up = PatchExpand(dim)

    def forward(self, x1, x2=None):
        if self.first:
            return self.layer_up(x1)
        x = self.layer_lka_1(self.x1_linear(x1) + x2)
        x = self.layer_lka_1(x) if self.reuse_first_lka else self.layer_lka_2(x)
        x = self.layer_up(x)
        return self.last_layer(x) if self.is_last else x


class _Backbone(nn.Module):
    """upstream's MaxViT4Out_Small wrapper: `backbone` is the encoder."""

    def __init__(self, img_size: int):
        super().__init__()
        self.backbone = MaxViT4Out(img_size=img_size)

    def forward(self, x):
        return self.backbone(x)


class MaxViTDeformableLKAFormer(nn.Module):
    """The 2D flagship. (B, H, W, 1 | 3) → logits (B, H, W, num_classes)."""

    def __init__(self, num_classes: int = 9, img_size: int = 224,
                 deformable: bool = True):
        super().__init__()
        self.backbone = _Backbone(img_size)
        kw = dict(n_class=num_classes, deformable=deformable)
        self.decoder_3 = DecoderLayer(768, first=True, **kw)
        self.decoder_2 = DecoderLayer(384, **kw)
        self.decoder_1 = DecoderLayer(192, **kw)
        self.decoder_0 = DecoderLayer(96, is_last=True, **kw)

    def forward(self, x):
        if x.shape[-1] == 1:
            x = x.repeat(1, 1, 1, 3)
        e0, e1, e2, e3 = self.backbone(x)
        t3 = self.decoder_3(e3)
        t2 = self.decoder_2(t3, e2)
        t1 = self.decoder_1(t2, e1)
        return self.decoder_0(t1, e0)


def _build(deformable: bool, num_classes: int, img_size: int, seed: int,
           device) -> MaxViTDeformableLKAFormer:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
    model = MaxViTDeformableLKAFormer(num_classes, img_size, deformable)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def maxvit_dlka_former(num_classes: int = 9, img_size: int = 224,
                       seed: int = 0, device="cuda") -> MaxViTDeformableLKAFormer:
    """The flagship, with random weights from `seed`, in eval mode."""
    return _build(True, num_classes, img_size, seed, device)


def maxvit_lka_former(num_classes: int = 9, img_size: int = 224,
                      seed: int = 0, device="cuda") -> MaxViTDeformableLKAFormer:
    """The non-deformable "LKA Baseline", with random weights from `seed`."""
    return _build(False, num_classes, img_size, seed, device)
