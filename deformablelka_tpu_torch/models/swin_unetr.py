"""Swin UNETR, channels-last (B, D, H, W, Cin) → (B, D, H, W, classes).

Tang et al., CVPR 2022 (arXiv 2111.14791; the architecture in
Hatamizadeh et al., arXiv 2201.01266), as MONAI's `SwinUNETR` computes
it: the 3D Swin encoder of `nn/swin3d.py` (`swinViT`) gives five hidden
states, at 1/2 … 1/32 of the input; MONAI's dynunet residual blocks
(`nn/dynunet.py`, instance norm without affine, leaky ReLU 0.01) take
them back up:

- `encoder1` = UnetResBlock(Cin → F) on the input; `encoder2`,
  `encoder3`, `encoder4` = UnetResBlock(C → C) on hidden states 0, 1, 2;
  `encoder10` = UnetResBlock(16F → 16F) on hidden state 4;
- `decoder5` … `decoder1` = a 2³ transposed conv, the skip concatenated,
  UnetResBlock(2·out → out): 16F → 8F (skip: hidden state 3), 8F → 4F,
  4F → 2F, 2F → F, F → F (skip: `encoder1`);
- `out` = a 1³ conv with bias to the logits.

State-dict keys are MONAI's (`swinViT.layers1.0.blocks.0.attn.qkv.weight`,
`encoder1.layer.conv1.conv.weight`, `decoder5.transp_conv.conv.weight`,
`out.conv.conv.weight`), so that a converter can load a public
checkpoint; the attention's `relative_position_index` is a non-persistent
buffer here. Patch merging takes the eight neighbours in MONAI's
`PatchMergingV2` order (MONAI's default `PatchMerging` takes another
pattern). The model returns one tensor: the training step scores it as
one scale (`training.train_step.model_loss`).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from deformablelka_tpu_torch.nn.dynunet import UnetOutBlock, UnetrBasicBlock, UnetrUpBlock
from deformablelka_tpu_torch.nn.layers import init_parameters
from deformablelka_tpu_torch.nn.swin3d import SwinTransformer3D

IN_CHANNELS = 1
DEPTHS = (2, 2, 2, 2)
NUM_HEADS = (3, 6, 12, 24)
WINDOW = (7, 7, 7)


class SwinUNETR(nn.Module):
    def __init__(self, out_channels: int, feature_size: int = 48, remat: bool = False):
        super().__init__()
        fs = feature_size
        self.swinViT = SwinTransformer3D(IN_CHANNELS, fs, DEPTHS, NUM_HEADS, WINDOW, remat)
        self.encoder1 = UnetrBasicBlock(IN_CHANNELS, fs)
        self.encoder2 = UnetrBasicBlock(fs, fs)
        self.encoder3 = UnetrBasicBlock(2 * fs, 2 * fs)
        self.encoder4 = UnetrBasicBlock(4 * fs, 4 * fs)
        self.encoder10 = UnetrBasicBlock(16 * fs, 16 * fs)
        self.decoder5 = UnetrUpBlock(16 * fs, 8 * fs)
        self.decoder4 = UnetrUpBlock(8 * fs, 4 * fs)
        self.decoder3 = UnetrUpBlock(4 * fs, 2 * fs)
        self.decoder2 = UnetrUpBlock(2 * fs, fs)
        self.decoder1 = UnetrUpBlock(fs, fs)
        self.out = UnetOutBlock(fs, out_channels)

    def forward(self, x_in):
        hidden = self.swinViT(x_in)
        enc0 = self.encoder1(x_in)
        enc1 = self.encoder2(hidden[0])
        enc2 = self.encoder3(hidden[1])
        enc3 = self.encoder4(hidden[2])
        dec4 = self.encoder10(hidden[4])
        dec3 = self.decoder5(dec4, hidden[3])
        dec2 = self.decoder4(dec3, enc3)
        dec1 = self.decoder3(dec2, enc2)
        dec0 = self.decoder2(dec1, enc1)
        return self.out(self.decoder1(dec0, enc0))


def swin_unetr_btcv(num_classes: int = 14, img_size=(96, 96, 96), feature_size: int = 48, *,
                    remat: bool = False, seed: int = 0, device="cuda") -> SwinUNETR:
    """The BTCV configuration (96³ crops, one CT channel, 14 classes,
    feature size 48, depths 2/2/2/2, heads 3/6/12/24, window 7),
    initialised from a `torch.Generator` seeded with `seed`, in eval mode,
    on `device`. Each side of `img_size` must be a multiple of 32."""
    if any(s % 32 for s in img_size):
        raise ValueError(f"Swin UNETR needs sides that are multiples of 32, got {img_size}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
    model = SwinUNETR(num_classes, feature_size=feature_size, remat=remat)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.eval().to(device)
