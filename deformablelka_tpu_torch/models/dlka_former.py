"""The 3D D-LKA Former, channels-last (B, D, H, W, C).

Port of `Encoder`, `UpBlock`, `DLKAFormer` and the three configurations
`dlka_former_synapse`, `dlka_former_acdc` and `dlka_net_pancreas` in
`deformablelka_tpu/models/dlka_former.py`. `trans_block` names the
transformer block of every encoder stage and up-block, from the registry
`nn.transformer3d.TRANSFORMER_BLOCKS`. Attribute names are upstream's
(`d_lka_former_encoder.downsample_layers`, `.stages`, `encoder1`,
`decoder5`…`decoder2`, `out1`…`out3`), so `state_dict()` converts with
`deformablelka_tpu.convert.torch_loader.convert_dlka_former`.

`remat=True` recomputes each transformer block of the encoder stages and
the up-blocks in the backward pass instead of keeping its activations
(`torch.utils.checkpoint`, the JAX package's `nn.remat`), whenever
gradients are on; inference is unaffected. The forward draws no random
numbers, so the recompute keeps no RNG state (`preserve_rng_state=False`).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Sequence

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from deformablelka_tpu_torch.nn.dynunet import UnetOutBlock, UnetResBlock
from deformablelka_tpu_torch.nn.layers import Conv3d, ConvTranspose, init_parameters
from deformablelka_tpu_torch.nn.norms import GroupNorm
from deformablelka_tpu_torch.nn.transformer3d import DEFAULT_BLOCK, TRANSFORMER_BLOCKS

# The blocks' token-attention sizes, as the JAX package's defaults: E's
# projection per encoder stage and in the up-blocks, and the heads.
PROJ_SIZES = (64, 64, 64, 32)
PROJ_SIZE = 64
NUM_HEADS = 4


def _run_blocks(blocks: nn.Sequential, x, remat: bool):
    for block in blocks:
        if remat and torch.is_grad_enabled():
            x = checkpoint(block, x, use_reentrant=False, preserve_rng_state=False)
        else:
            x = block(x)
    return x


def _wrapped(module: nn.Module) -> nn.Sequential:
    """MONAI's `Convolution`: the layer as a child named `conv`."""
    return nn.Sequential(OrderedDict(conv=module))


class Encoder(nn.Module):
    """Stem + 3 stride-2 downsamples, each with GroupNorm and a stack of
    transformer blocks. Returns the four stages' outputs."""

    def __init__(self, in_channels: int, dims: Sequence[int],
                 depths: Sequence[int], input_sizes: Sequence[int],
                 patch_size, remat: bool = False,
                 trans_block: str = DEFAULT_BLOCK):
        super().__init__()
        Block = TRANSFORMER_BLOCKS[trans_block]
        self.remat = remat
        self.downsample_layers = nn.ModuleList()
        self.downsample_layers.append(nn.Sequential(
            _wrapped(Conv3d(in_channels, dims[0], patch_size,
                            stride=patch_size, padding=0, bias=False)),
            GroupNorm(in_channels, dims[0])))
        for i in range(1, 4):
            self.downsample_layers.append(nn.Sequential(
                _wrapped(Conv3d(dims[i - 1], dims[i], 2, stride=2, padding=0,
                                bias=False)),
                GroupNorm(dims[i - 1], dims[i])))
        self.stages = nn.ModuleList(
            nn.Sequential(*[Block(input_sizes[i], dims[i], PROJ_SIZES[i],
                                  NUM_HEADS) for _ in range(depths[i])])
            for i in range(4))

    def forward(self, x):
        hidden = []
        for down, stage in zip(self.downsample_layers, self.stages):
            x = _run_blocks(stage, down(x), self.remat)
            hidden.append(x)
        return hidden


class UpBlock(nn.Module):
    """Transposed-conv upsample + additive skip + transformer blocks, or a
    UnetResBlock (instance norm) when `conv_decoder`."""

    def __init__(self, in_channels: int, out_channels: int,
                 upsample_kernel_size, out_size: int, depth: int = 3,
                 conv_decoder: bool = False, remat: bool = False,
                 trans_block: str = DEFAULT_BLOCK):
        super().__init__()
        self.conv_decoder, self.remat = conv_decoder, remat
        self.transp_conv = _wrapped(ConvTranspose(
            in_channels, out_channels, upsample_kernel_size,
            stride=upsample_kernel_size, bias=False))
        if conv_decoder:
            block = UnetResBlock(out_channels, out_channels, 3, 1,
                                 norm_name="instance")
        else:
            Block = TRANSFORMER_BLOCKS[trans_block]
            block = nn.Sequential(*[Block(out_size, out_channels, PROJ_SIZE,
                                          NUM_HEADS) for _ in range(depth)])
        self.decoder_block = nn.ModuleList([block])

    def forward(self, x, skip):
        x = self.transp_conv(x) + skip
        if self.conv_decoder:
            return self.decoder_block[0](x)
        return _run_blocks(self.decoder_block[0], x, self.remat)


class DLKAFormer(nn.Module):
    """The 3D flagship on (B, S1, S2, S3, Cin). Returns the full-resolution
    logits, or [full, 1/2, 1/4] logits when `do_ds`, channels-last."""

    def __init__(self, out_channels: int, in_channels: int = 1,
                 img_size=(64, 128, 128), patch_size=(2, 4, 4),
                 feature_size: int = 16, depths=(3, 3, 3, 3),
                 dims=(32, 64, 128, 256), do_ds: bool = True,
                 remat: bool = False, trans_block: str = DEFAULT_BLOCK):
        super().__init__()
        self.do_ds = do_ds
        s = [img_size[i] // patch_size[i] for i in range(3)]
        input_sizes = [math.prod(v // 2 ** i for v in s) for i in range(4)]
        fs = feature_size
        self.d_lka_former_encoder = Encoder(
            in_channels, dims, depths, input_sizes, patch_size, remat,
            trans_block)
        up = dict(remat=remat, trans_block=trans_block)
        self.encoder1 = UnetResBlock(in_channels, fs, 3, 1,
                                     norm_name="instance")
        self.decoder5 = UpBlock(dims[3], fs * 8, 2, input_sizes[2], **up)
        self.decoder4 = UpBlock(fs * 8, fs * 4, 2, input_sizes[1], **up)
        self.decoder3 = UpBlock(fs * 4, fs * 2, 2, input_sizes[0], **up)
        self.decoder2 = UpBlock(fs * 2, fs, patch_size, math.prod(img_size),
                                conv_decoder=True)
        self.out1 = UnetOutBlock(fs, out_channels)
        if do_ds:
            self.out2 = UnetOutBlock(fs * 2, out_channels)
            self.out3 = UnetOutBlock(fs * 4, out_channels)

    def forward(self, x_in):
        enc1, enc2, enc3, enc4 = self.d_lka_former_encoder(x_in)
        conv_block = self.encoder1(x_in)
        dec3 = self.decoder5(enc4, enc3)
        dec2 = self.decoder4(dec3, enc2)
        dec1 = self.decoder3(dec2, enc1)
        out = self.decoder2(dec1, conv_block)
        logits = self.out1(out)
        if self.do_ds:
            return [logits, self.out2(dec1), self.out3(dec2)]
        return logits


def _build(model: DLKAFormer, seed: int, device) -> DLKAFormer:
    """`model` initialised from a `torch.Generator` seeded with `seed`, in
    eval mode, on `device` (the card unless the caller asks for the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.eval().to(device)


def dlka_former_synapse(num_classes: int = 14, do_ds: bool = True,
                        img_size=(64, 128, 128), *, remat: bool = False,
                        trans_block: str = DEFAULT_BLOCK, seed: int = 0,
                        device="cuda") -> DLKAFormer:
    """The Synapse configuration (patch 64×128×128, stem patch (2, 4,
    4)), with `trans_block` in every stage (the published block unless
    asked)."""
    return _build(DLKAFormer(out_channels=num_classes, img_size=tuple(img_size),
                             patch_size=(2, 4, 4), do_ds=do_ds, remat=remat,
                             trans_block=trans_block), seed, device)


def dlka_former_acdc(num_classes: int = 4, do_ds: bool = True,
                     img_size=(16, 160, 160), *, remat: bool = False,
                     trans_block: str = DEFAULT_BLOCK, seed: int = 0,
                     device="cuda") -> DLKAFormer:
    """The ACDC configuration (crop 16×160×160, stem patch (1, 4, 4)).
    The ACDC code's block of the published name has dim-dependent
    anisotropic gate kernels: that name maps onto the `_acdc` variant."""
    if trans_block == DEFAULT_BLOCK:
        trans_block = DEFAULT_BLOCK + "_acdc"
    return _build(DLKAFormer(out_channels=num_classes, img_size=tuple(img_size),
                             patch_size=(1, 4, 4), do_ds=do_ds, remat=remat,
                             trans_block=trans_block), seed, device)


def dlka_net_pancreas(num_classes: int = 2, do_ds: bool = False,
                      img_size=(96, 96, 96), *, trans_block: str = DEFAULT_BLOCK,
                      seed: int = 0, device="cuda") -> DLKAFormer:
    """The NIH Pancreas D-LKA Net (96³ inputs, stem patch (2, 2, 2):
    stages 48³…6³), with `trans_block` in every stage (the published block
    unless asked)."""
    return _build(DLKAFormer(out_channels=num_classes, img_size=tuple(img_size),
                             patch_size=(2, 2, 2), do_ds=do_ds,
                             trans_block=trans_block), seed, device)
