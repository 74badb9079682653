"""DAE-LKA: DAEFormer's dual-attention encoder and the LKA decoder.

Port of `deformablelka_tpu/models/dae_lka.py` (upstream's
`2D/networks/DAEEncoder_LKADecoder.py`, DAELKAFormer): the MiT3 encoder of
`models/daeformer.py` (dims 128/320/512 at /4, /8, /16) and the LKA
Baseline's decoder layers of `models/maxvit_dlka.py` (`deformable=False`:
linear map of x1, additive skip, `layer_lka_1` applied twice, expand).
`decoder_2` expands the 14²×512 map to 28²×256, so `decoder_1` maps 256
channels to 320 and `decoder_0` 160 to 128. Each decoder's two LKA blocks
run `ops.kernels.dw_chain2d` once each: 4 launches per forward, at
28²×320 and 56²×128.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn as nn

from deformablelka_tpu_torch.models.daeformer import MiT3
from deformablelka_tpu_torch.models.maxvit_dlka import DecoderLayer


class DAELKAFormer(nn.Module):
    """(B, H, W, 1 | 3) → logits (B, H, W, num_classes)."""

    jax_renames = ()

    def __init__(self, num_classes: int = 9, head_count: int = 1,
                 token_mlp: str = "mix_skip", dims: Sequence[int] = (128, 320, 512),
                 layers: Sequence[int] = (2, 2, 2)):
        super().__init__()
        d0, d1, d2 = dims
        self.backbone = MiT3(dims, layers, head_count, token_mlp)
        kw = dict(n_class=num_classes, deformable=False)
        self.decoder_2 = DecoderLayer(d2, first=True, **kw)
        self.decoder_1 = DecoderLayer(d1, in_dim=d2 // 2, **kw)
        self.decoder_0 = DecoderLayer(d0, in_dim=d1 // 2, is_last=True, **kw)

    def forward(self, x):
        if x.shape[-1] == 1:
            x = x.repeat(1, 1, 1, 3)
        e0, e1, e2 = self.backbone(x)
        return self.decoder_0(self.decoder_1(self.decoder_2(e2), e1), e0)
