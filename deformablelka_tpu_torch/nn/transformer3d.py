"""The 3D transformer blocks of the D-LKA Former family (channels-last),
and their registry.

Port of `_SkeletonBlock` and `TRANSFORMER_BLOCKS` in
`deformablelka_tpu/nn/transformer3d.py`. Every block is

    tokens = flatten(x) + pos_embed
    y = unflatten(tokens + gamma · inner(norm(tokens)))
    out = y + conv8(conv51(y))        # UnetResBlock (batch norm) + 1³ conv

with the inner module chosen by the block's `inner_kind`, and
`TransformerBlock_SE` gating the tokens by squeeze-and-excitation before
the norm (its inner module is `LKA_block`, the plain LKA gate).

Attribute names are upstream's: `pos_embed`, `gamma`, `norm`,
`epa_block`, `conv51`, and `conv8` as Sequential(Dropout3d, Conv3d), so
its conv is `conv8.1`; `se.fc1`/`se.fc2` and `LKA_block` in the SE block.
Where the JAX package splits a paired block's inner module into `attn`,
`lka`, `fuse_norm`… at block level, upstream (and the port) hold them all
in `epa_block`: `epa_block.{qkv, E, temperature}`, `epa_block.lka`,
`epa_block.norm`/`norm2`, `epa_block.out_proj`/`out_proj2`,
`epa_block.temperature2`.

The JAX trainers and the bench build the model with `deterministic=True`
(`cli/run_training.py:81-84`), and the `*_sequential` kinds fix their
dropout at 0 and `deterministic` at True: every dropout is the identity and
`conv51`'s batch norm normalises with its running statistics, so this
forward is also the training forward.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from deformablelka_tpu_torch.nn import blocks3d as B3
from deformablelka_tpu_torch.nn.dynunet import UnetResBlock
from deformablelka_tpu_torch.nn.layers import Conv3d, Linear
from deformablelka_tpu_torch.nn.norms import LayerNorm

_GATES = {"lka": B3.LKA3d, "lka_deform": B3.LKA3dDeform,
          "lka_deform_acdc": B3.LKA3dDeformACDC, "lka_conv": B3.LKA3dConv}
_SPATIAL = ("lka_spatial", "deform_lka_spatial", "deform_lka_spatial_seq")


class AttentionLKA(nn.Module):
    """The inner module of the paired kinds: a token attention (spatial
    or channel; its parameters at this level) beside or before a gated LKA
    (`lka`), fused by out-projections.

    - parallel (`lka_spatial`, `deform_lka_spatial`, `lka_channel`,
      `deform_lka_channel`, `lka_channel_norm`): attention and LKA on the
      same tokens, each out-projected to C/2 (`out_proj` takes the LKA
      branch for the spatial kinds and the attention for the channel
      kinds), concatenated with the attention's half first for the spatial
      kinds and the LKA's first for the channel ones; `lka_channel_norm`
      scales the LKA branch by `temperature2` and norms both branches
      (`norm` the attention's, `norm2` the LKA's) before their projections;
    - sequential (`*_seq`): attention → `norm` → LKA with the size-aware
      gate → `norm2` → `out_proj` (C → C).
    """

    def __init__(self, kind: str, input_size: int, hidden_size: int,
                 proj_size: int, num_heads: int):
        super().__init__()
        C = hidden_size
        self.kind = kind
        self.spatial = kind in _SPATIAL
        if self.spatial:
            B3._init_spatial_attention(self, C, num_heads, input_size, proj_size)
        else:
            B3._init_channel_attention(self, C, num_heads)
        if kind.endswith("_seq"):
            self.norm = LayerNorm(C)
            self.lka = B3.GatedAttention3d(C, gate=B3.LKA3dDeformSizeAware)
            self.norm2 = LayerNorm(C)
            self.out_proj = Linear(C, C)
            return
        gate = B3.LKA3dDeform if kind.startswith("deform_") else B3.LKA3d
        self.lka = B3.GatedAttention3d(C, gate=gate)
        if kind == "lka_channel_norm":
            self.temperature2 = nn.Parameter(torch.ones(1, 1, 1))
            self.norm = LayerNorm(C)
            self.norm2 = LayerNorm(C)
        self.out_proj = Linear(C, C // 2)
        self.out_proj2 = Linear(C, C // 2)

    def forward(self, tokens, vol_shape):
        attend = B3._spatial_attention if self.spatial else B3._channel_attention
        a = attend(self, tokens)
        if self.kind.endswith("_seq"):
            out = self.lka(self.norm(a).reshape(vol_shape)).reshape(tokens.shape)
            return self.out_proj(self.norm2(out))
        x_lka = self.lka(tokens.reshape(vol_shape)).reshape(tokens.shape)
        if self.spatial:
            return torch.cat([self.out_proj2(a), self.out_proj(x_lka)], -1)
        if self.kind == "lka_channel_norm":
            a, x_lka = self.norm(a), self.norm2(x_lka * self.temperature2[0])
        return torch.cat([self.out_proj2(x_lka), self.out_proj(a)], -1)


class SqueezeExcite(nn.Module):
    """x · sigmoid(fc2(relu(fc1(mean over space of x)))), C → C/4 → C."""

    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = Conv3d(dim, int(dim * 0.25), 1)
        self.fc2 = Conv3d(int(dim * 0.25), dim, 1)

    def forward(self, x):
        s = x.mean((1, 2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(torch.relu(self.fc1(s))))


class _SkeletonBlock(nn.Module):
    inner_kind = "lka_deform"

    def __init__(self, input_size: int, hidden_size: int, proj_size: int = 64,
                 num_heads: int = 4):
        super().__init__()
        C, kind = hidden_size, self.inner_kind
        self.pos_embed = nn.Parameter(torch.zeros(1, input_size, C))
        if kind == "se_lka":
            self.se = SqueezeExcite(C)
        self.gamma = nn.Parameter(torch.full((C,), 1e-6))
        self.norm = LayerNorm(C)
        if kind == "se_lka":
            self.LKA_block = B3.GatedAttention3d(C, gate=B3.LKA3d)
        elif kind == "epa":
            self.epa_block = B3.EPA(input_size, C, proj_size, num_heads)
        elif kind == "ea":
            self.epa_block = B3.EfficientAttention(C, num_heads)
        elif kind in _GATES:
            self.epa_block = B3.GatedAttention3d(C, gate=_GATES[kind])
        elif kind == "lka_2dslice":
            self.epa_block = B3.SliceDeformableLKA2d(C)
        else:
            self.epa_block = AttentionLKA(kind, input_size, C, proj_size,
                                          num_heads)
        self.conv51 = UnetResBlock(C, C, 3, 1, norm_name="batch")
        self.conv8 = nn.Sequential(nn.Identity(), Conv3d(C, C, 1))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.pos_embed.zero_()
            self.gamma.fill_(1e-6)

    def _inner(self, tokens, vol_shape):
        if self.inner_kind == "se_lka":
            return self.LKA_block(tokens.reshape(vol_shape)).reshape(tokens.shape)
        if isinstance(self.epa_block, AttentionLKA):
            return self.epa_block(tokens, vol_shape)
        if isinstance(self.epa_block, (B3.EPA, B3.EfficientAttention)):
            return self.epa_block(tokens)
        return self.epa_block(tokens.reshape(vol_shape)).reshape(tokens.shape)

    def forward(self, x):
        B, S1, S2, S3, C = x.shape
        tokens = x.reshape(B, S1 * S2 * S3, C) + self.pos_embed
        if self.inner_kind == "se_lka":
            tokens = self.se(tokens.reshape(x.shape)).reshape(tokens.shape)
        inner = self._inner(self.norm(tokens), x.shape)
        y = (tokens + self.gamma * inner).reshape(x.shape)
        return y + self.conv8(self.conv51(y))


def _make(name: str, kind: str) -> type:
    return type(name, (_SkeletonBlock,), {"inner_kind": kind,
                                          "__module__": __name__})


# The reference's --trans_block names (`run_training.py:124-129`).
TRANSFORMER_BLOCKS = {name: _make(name, kind) for name, kind in (
    ("TransformerBlock", "epa"),
    ("TransformerBlock_EA", "ea"),
    ("TransformerBlock_3D_LKA", "lka"),
    ("TransformerBlock_2Dsingle", "lka_2dslice"),
    ("TransformerBlock_3D_single_deform_LKA", "lka_deform"),
    # the ACDC file's class of this name has dim-dependent anisotropic
    # kernels; `dlka_former_acdc` maps the name onto this variant
    ("TransformerBlock_3D_single_deform_LKA_acdc", "lka_deform_acdc"),
    ("TransformerBlock_3D_LKA_3D_conv", "lka_conv"),
    ("TransformerBlock_LKA_Spatial", "lka_spatial"),
    ("TransformerBlock_LKA_Channel", "lka_channel"),
    ("TransformerBlock_LKA_Channel_norm", "lka_channel_norm"),
    ("TransformerBlock_SE", "se_lka"),
    ("TransformerBlock_Deform_LKA_Channel", "deform_lka_channel"),
    ("TransformerBlock_Deform_LKA_Channel_sequential", "deform_lka_channel_seq"),
    ("TransformerBlock_Deform_LKA_Spatial", "deform_lka_spatial"),
    ("TransformerBlock_Deform_LKA_Spatial_sequential", "deform_lka_spatial_seq"),
)}
DEFAULT_BLOCK = "TransformerBlock_3D_single_deform_LKA"
TransformerBlock_3D_single_deform_LKA = TRANSFORMER_BLOCKS[DEFAULT_BLOCK]
