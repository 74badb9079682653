"""The 3D transformer block of the D-LKA Former (channels-last).

Port of `_SkeletonBlock` in `deformablelka_tpu/nn/transformer3d.py` with
the inner kind `lka_deform` (`TransformerBlock_3D_single_deform_LKA`):

    tokens = flatten(x) + pos_embed
    y = unflatten(tokens + gamma · epa_block(norm(tokens)))
    out = y + conv8(conv51(y))        # UnetResBlock (batch norm) + 1³ conv

Attribute names are upstream's: `pos_embed`, `gamma`, `norm`,
`epa_block`, `conv51`, and `conv8` as Sequential(Dropout3d, Conv3d), so
its conv is `conv8.1`. The JAX trainers build the model with
`deterministic=True` (`cli/run_training.py:81-84`; `bench.py`'s training
step takes the default), so in training too the dropout is the identity
and `conv51`'s batch norm normalises with its running statistics: this
forward is the training forward as well.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from deformablelka_tpu_torch.nn.blocks3d import GatedAttention3d, LKA3dDeform
from deformablelka_tpu_torch.nn.dynunet import UnetResBlock
from deformablelka_tpu_torch.nn.layers import Conv3d
from deformablelka_tpu_torch.nn.norms import LayerNorm


class _SkeletonBlock(nn.Module):
    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        C = hidden_size
        self.pos_embed = nn.Parameter(torch.zeros(1, input_size, C))
        self.gamma = nn.Parameter(torch.full((C,), 1e-6))
        self.norm = LayerNorm(C)
        self.epa_block = GatedAttention3d(C, gate=LKA3dDeform)
        self.conv51 = UnetResBlock(C, C, 3, 1, norm_name="batch")
        self.conv8 = nn.Sequential(nn.Identity(), Conv3d(C, C, 1))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.pos_embed.zero_()
            self.gamma.fill_(1e-6)

    def forward(self, x):
        B, S1, S2, S3, C = x.shape
        tokens = x.reshape(B, S1 * S2 * S3, C) + self.pos_embed
        inner = self.epa_block(self.norm(tokens).reshape(x.shape))
        y = (tokens + self.gamma * inner.reshape(tokens.shape)).reshape(x.shape)
        return y + self.conv8(self.conv51(y))


class TransformerBlock_3D_single_deform_LKA(_SkeletonBlock):
    """The published 3D D-LKA block, the only kind this slice ports."""
