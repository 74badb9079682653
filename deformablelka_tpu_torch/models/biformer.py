"""BiDAEFormer: the BiFormer encoder and DAEFormer's decoder.

Port of `deformablelka_tpu/models/biformer.py` (upstream's
`2D/networks/BiEncoderDAEDecoder.py`), channels-last, with upstream's
torch attribute names:

    BiLevelRoutingAttention: the map padded to the n_win grid; per window
        q, k, v (`qkv.qkv`, q and k of `dim` channels); window-level
        routing: the windows' mean q against their mean k, the `topk`
        windows of each taken in `lax.top_k`'s order (value descending,
        the lower index first among equals; `routing_indices`), their k
        and v pixels gathered; multi-head attention of each window's
        pixels over them; LePE (depthwise 5²) on v; `wo`; crop;
    AttentionLePE: full attention plus LePE, 8 heads (upstream's Block
        leaves `num_heads` at its default);
    BiFormerBlock (upstream's Block): + pos_embed (depthwise 3²), pre-norm
        attention and MLP (ratio 3), LayerNorm eps 1e-6;
    BiFormer3Out (BiFormer_mm): stem (two 3²/2 convs with batch norm,
        GELU between), 3²/2 conv + batch norm between stages, depths
        4/18/4, dims 128/320/512, topks 1/16/-2 (-2: AttentionLePE),
        LayerNorm (eps 1e-6) per output;
    BiDAEFormer: that encoder and `models/daeformer.py`'s decoder layers.

The routing is hard (no gradient through the choice), as upstream's
detached logits.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from deformablelka_tpu_torch.models.daeformer import dae_decoders
from deformablelka_tpu_torch.nn.layers import Conv2d, Linear
from deformablelka_tpu_torch.nn.norms import BatchNorm, LayerNorm
from deformablelka_tpu_torch.nn.segformer import attend


def routing_indices(q_win, k_win, topk: int, scale: float):
    """The `topk` windows each window routes to: indices into the p²
    windows of the logits (q_win·scale)·k_winᵀ, largest first and, among
    equal logits, the lower index first (`lax.top_k`). q_win, k_win (n,
    p², c) → (n, p², topk) int64."""
    logits = torch.matmul(q_win.detach() * scale, k_win.detach().transpose(-1, -2))
    return torch.sort(logits, dim=-1, descending=True, stable=True).indices[..., :topk]


class QKVLinear(nn.Module):
    def __init__(self, dim: int, qk_dim: int):
        super().__init__()
        self.qkv = Linear(dim, 2 * qk_dim + dim)

    def forward(self, x):
        return self.qkv(x)


class BiLevelRoutingAttention(nn.Module):
    """Bi-level routing attention, identity k/v downsampling, NHWC."""

    jax_renames = (("qkv", "qkv.qkv"),)

    def __init__(self, dim: int, num_heads: int, n_win: int = 8, topk: int = 4,
                 side_dwconv: int = 5):
        super().__init__()
        self.dim, self.num_heads, self.n_win, self.topk = dim, num_heads, n_win, topk
        self.qkv = QKVLinear(dim, dim)
        self.lepe = Conv2d(dim, dim, side_dwconv, groups=dim)
        self.wo = Linear(dim, dim)

    def forward(self, x):
        N, H_in, W_in, C = x.shape
        nw, qk = self.n_win, self.dim
        pad_b, pad_r = (-H_in) % nw, (-W_in) % nw
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        H, W = H_in + pad_b, W_in + pad_r
        h, w = H // nw, W // nw
        p2, hw = nw * nw, (H // nw) * (W // nw)
        xw = x.reshape(N, nw, h, nw, w, C).permute(0, 1, 3, 2, 4, 5).reshape(N, p2, h, w, C)
        qkv = self.qkv(xw)
        q, kv = qkv[..., :qk], qkv[..., qk:]
        q_win, k_win = q.mean((2, 3)), kv[..., :qk].mean((2, 3))
        v_map = kv[..., qk:].reshape(N, nw, nw, h, w, C).permute(0, 1, 3, 2, 4, 5)
        lepe = self.lepe(v_map.reshape(N, H, W, C))

        idx = routing_indices(q_win, k_win, self.topk, qk ** -0.5)   # (N, p², topk)
        kv_pix = kv.reshape(N, p2, hw, qk + C)
        kv_sel = torch.gather(kv_pix[:, None].expand(-1, p2, -1, -1, -1), 2,
                              idx[..., None, None].expand(-1, -1, -1, hw, qk + C))
        m = self.num_heads
        L = self.topk * hw
        k_sel = kv_sel[..., :qk].reshape(N, p2, L, m, qk // m).transpose(2, 3)
        v_sel = kv_sel[..., qk:].reshape(N, p2, L, m, C // m).transpose(2, 3)
        qh = q.reshape(N, p2, hw, m, qk // m).transpose(2, 3)
        out = attend(qh * qk ** -0.5, k_sel, v_sel, 1.0)          # (N, p², m, hw, c)
        out = out.transpose(2, 3).reshape(N, nw, nw, h, w, C)
        out = out.permute(0, 1, 3, 2, 4, 5).reshape(N, H, W, C)
        out = self.wo(out + lepe)
        return out[:, :H_in, :W_in] if pad_b or pad_r else out


class AttentionLePE(nn.Module):
    """Full attention plus LePE, NHWC."""

    def __init__(self, dim: int, num_heads: int = 8, side_dwconv: int = 5):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, bias=False)
        self.lepe = Conv2d(dim, dim, side_dwconv, groups=dim)
        self.proj = Linear(dim, dim)

    def forward(self, x):
        B, H, W, C = x.shape
        N, m = H * W, self.num_heads
        qkv = self.qkv(x.reshape(B, N, C)).reshape(B, N, 3, m, C // m).permute(2, 0, 3, 1, 4)
        o = attend(qkv[0], qkv[1], qkv[2], (C // m) ** -0.5)
        o = o.transpose(1, 2).reshape(B, N, C) + self.lepe(x).reshape(B, N, C)
        return self.proj(o).reshape(B, H, W, C)


class BiFormerBlock(nn.Module):
    """upstream's Block; `topk` > 0 routes, else full attention + LePE."""

    jax_renames = (("fc1", "mlp.0"), ("fc2", "mlp.3"))

    def __init__(self, dim: int, num_heads: int, n_win: int = 8, topk: int = 4,
                 mlp_ratio: float = 3.0, side_dwconv: int = 5):
        super().__init__()
        self.pos_embed = Conv2d(dim, dim, 3, groups=dim)
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = (BiLevelRoutingAttention(dim, num_heads, n_win, topk, side_dwconv)
                     if topk > 0 else AttentionLePE(dim, 8, side_dwconv))
        self.norm2 = LayerNorm(dim, eps=1e-6)
        hidden = int(dim * mlp_ratio)
        self.mlp = nn.Sequential(Linear(dim, hidden), nn.Identity(), nn.GELU(),
                                 Linear(hidden, dim))

    def forward(self, x):
        x = x + self.pos_embed(x)
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class BiFormer3Out(nn.Module):
    """BiFormer_mm's 3-stage backbone: NHWC maps at /4, /8, /16."""

    jax_renames = (("stem_conv1", "downsample_layers.0.0"),
                   ("stem_bn1", "downsample_layers.0.1"),
                   ("stem_conv2", "downsample_layers.0.3"),
                   ("stem_bn2", "downsample_layers.0.4"),
                   (r"down(\d)_conv", r"downsample_layers.\1.0"),
                   (r"down(\d)_bn", r"downsample_layers.\1.1"),
                   (r"stage(\d)_blk(\d+)", r"stages.\1.\2"),
                   (r"extra_norm(\d)", r"extra_norms.\1"))

    def __init__(self, dims: Sequence[int] = (128, 320, 512),
                 depths: Sequence[int] = (4, 18, 4), head_dim: int = 32, n_win: int = 8,
                 topks: Sequence[int] = (1, 16, -2), mlp_ratio: float = 3.0):
        super().__init__()
        d0 = dims[0]
        layers = [nn.Sequential(Conv2d(3, d0 // 2, 3, stride=2, padding=1),
                                BatchNorm(d0 // 2), nn.GELU(),
                                Conv2d(d0 // 2, d0, 3, stride=2, padding=1), BatchNorm(d0))]
        layers += [nn.Sequential(Conv2d(dims[s - 1], dims[s], 3, stride=2, padding=1),
                                 BatchNorm(dims[s])) for s in range(1, len(dims))]
        self.downsample_layers = nn.ModuleList(layers)
        self.stages = nn.ModuleList(
            nn.Sequential(*(BiFormerBlock(d, d // head_dim, n_win, topk, mlp_ratio)
                            for _ in range(depth)))
            for d, depth, topk in zip(dims, depths, topks))
        self.extra_norms = nn.ModuleList(LayerNorm(d, eps=1e-6) for d in dims)

    def forward(self, x):
        outs = []
        for down, stage, norm in zip(self.downsample_layers, self.stages, self.extra_norms):
            x = stage(down(x))
            outs.append(norm(x))
        return outs


class BiDAEFormer(nn.Module):
    """(B, H, W, 1 | 3) → logits (B, H, W, num_classes)."""

    jax_renames = ()

    def __init__(self, num_classes: int = 9, head_count: int = 1,
                 token_mlp: str = "mix_skip", dims: Sequence[int] = (128, 320, 512),
                 depths: Sequence[int] = (4, 18, 4), topks: Sequence[int] = (1, 16, -2)):
        super().__init__()
        self.backbone = BiFormer3Out(dims=dims, depths=depths, topks=topks)
        self.decoder_2, self.decoder_1, self.decoder_0 = dae_decoders(
            dims, num_classes, head_count, token_mlp)

    def forward(self, x):
        if x.shape[-1] == 1:
            x = x.repeat(1, 1, 1, 3)
        e0, e1, e2 = self.backbone(x)
        return self.decoder_0(self.decoder_1(self.decoder_2(e2), e1), e0)

