"""The MaxViT encoder (`maxvit_rmlp_small_rw_224`, four outputs), NHWC.

Port of `deformablelka_tpu/models/maxvit.py` with the attribute names and
layouts of timm's `MaxxVit` (upstream's vendored `maxxvit_4out.py`):
embed dims (96, 192, 384, 768), depths (2, 2, 5, 2), stem (32, 64),
MBConv with SE and an avg-pool shortcut, then block- and grid-partition
attention with a relative-position MLP bias, head dim 32, layer scale,
LayerNorm eps 1e-6; the last feature is LayerNorm-ed. Windows are
img_size / 32 (7 at 224²).

Attention is `torch.matmul` and a softmax in float32, as the JAX package
leaves it to XLA: it is no Pallas kernel, and plain matmuls keep the
comparison with the JAX package tight. Each partition, attention and
reverse opens the span `dlka.maxvit.attention` (args: partition "block"
or "grid", windows) and adds its windows to the counter
`dlka.maxvit.windows` (`profiling.span`, `profiling.count`): B·(H/7)·(W/7)
an attention, 8736 a forward of the 224² encoder at B = 24.

On a bfloat16 input the stem, the first MBConv and the first block's
attention run in bfloat16 and its layer scale promotes to float32, as in
the JAX package; there the ops round as JAX's do: the sigmoid as
1 / (1 + exp(−x)) rounded at each step (XLA's expansion of the
logistic), SiLU as x · sigmoid(x) (`jax.nn.silu`), the 2×2 average pool as
three additions in order then a division (flax's `avg_pool`, a window
sum), the attention scale rounded to the input's type (a weak-typed
Python scalar in JAX). In float32 they are torch's fused ops.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from deformablelka_tpu_torch import profiling
from deformablelka_tpu_torch.nn.layers import Conv2d, Linear, gelu, scalar_in
from deformablelka_tpu_torch.nn.norms import BatchNorm, LayerNorm
from deformablelka_tpu_torch.ops.convs import to_nchw, to_nhwc


def _make_divisible(v, divisor=8, min_value=None, round_limit=0.9):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < round_limit * v:
        new_v += divisor
    return new_v


def sigmoid(x):
    """jax.nn.sigmoid: in float32 torch's, else 1 / (1 + exp(−x)) with each
    step rounded to x's type, as XLA expands the logistic."""
    return torch.sigmoid(x) if x.dtype == torch.float32 else 1 / (1 + torch.exp(-x))


def silu(x):
    """jax.nn.silu, x · sigmoid(x): in float32 torch's fused SiLU, else
    the product of x and the rounded `sigmoid(x)`."""
    return F.silu(x) if x.dtype == torch.float32 else x * sigmoid(x)


class BNAct(BatchNorm):
    """Batch norm (eval statistics, eps 1e-5), then SiLU if `act`."""

    def __init__(self, num_channels: int, act: bool = True):
        super().__init__(num_channels)
        self.act = act

    def forward(self, x):
        x = super().forward(x)
        return silu(x) if self.act else x


class SEModule(nn.Module):
    def __init__(self, channels: int, rd_channels: int):
        super().__init__()
        self.fc1 = Conv2d(channels, rd_channels, 1)
        self.fc2 = Conv2d(rd_channels, channels, 1)

    def forward(self, x):
        s = x.mean((1, 2), keepdim=True)
        s = self.fc2(silu(self.fc1(s)))
        return x * sigmoid(s)


def avg_pool2(x):
    """2×2 average pool, stride 2: in float32 torch's, else flax's window
    sum, the four values added in row-major order (each sum rounded to x's
    type), divided by 4."""
    if x.dtype == torch.float32:
        return to_nhwc(F.avg_pool2d(to_nchw(x), 2))
    s = x[:, 0::2, 0::2] + x[:, 0::2, 1::2]
    return (s + x[:, 1::2, 0::2] + x[:, 1::2, 1::2]) / 4


class Downsample2d(nn.Module):
    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.expand = (Conv2d(dim, dim_out, 1, bias=False) if dim != dim_out
                       else nn.Identity())

    def forward(self, x):
        return self.expand(avg_pool2(x))


class MbConv(nn.Module):
    """rw-variant MBConv: expand from the input channels ×4, SiLU, SE
    1/16 of mid, no output bias, stride on the depthwise conv."""

    def __init__(self, in_chs: int, out_chs: int, stride: int = 1,
                 expand_ratio: float = 4.0):
        super().__init__()
        mid = _make_divisible(in_chs * expand_ratio)
        self.stride = stride
        self.shortcut = Downsample2d(in_chs, out_chs) if stride == 2 else None
        self.pre_norm = BNAct(in_chs, act=False)
        self.conv1_1x1 = Conv2d(in_chs, mid, 1, bias=False)
        self.norm1 = BNAct(mid)
        self.conv2_kxk = Conv2d(mid, mid, 3, stride=stride, padding=1,
                                groups=mid, bias=False)
        self.norm2 = BNAct(mid)
        self.se = SEModule(mid, int(mid * (1 / 16)))
        self.conv3_1x1 = Conv2d(mid, out_chs, 1, bias=False)

    def forward(self, x):
        shortcut = x if self.shortcut is None else self.shortcut(x)
        x = self.norm1(self.conv1_1x1(self.pre_norm(x)))
        x = self.se(self.norm2(self.conv2_kxk(x)))
        return self.conv3_1x1(x) + shortcut


def window_partition(x, ws):
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, C)


def window_reverse(w, ws, H, W):
    C = w.shape[-1]
    x = w.reshape(-1, H // ws, W // ws, ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, H, W, C)


def grid_partition(x, gs):
    B, H, W, C = x.shape
    x = x.reshape(B, gs, H // gs, gs, W // gs, C)
    return x.permute(0, 2, 4, 1, 3, 5).reshape(-1, gs, gs, C)


def grid_reverse(w, gs, H, W):
    C = w.shape[-1]
    x = w.reshape(-1, H // gs, W // gs, gs, gs, C)
    return x.permute(0, 3, 1, 4, 2, 5).reshape(-1, H, W, C)


def _rel_log_coords(ws: int) -> np.ndarray:
    """'cr'-mode log coords: sign(Δ)·log(1 + |Δ|), (2w−1, 2w−1, 2)."""
    r = np.arange(-(ws - 1), ws, dtype=np.float32)
    table = np.stack(np.meshgrid(r, r, indexing="ij"), axis=-1)
    return np.sign(table) * np.log1p(np.abs(table))


def _rel_index(ws: int) -> np.ndarray:
    """(w², w²) index into the flattened (2w−1)² table: the rank of the
    pair (Δy, Δx), (Δy + w − 1)·(2w − 1) + (Δx + w − 1)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"), 0).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    return ((rel[0] + ws - 1) * (2 * ws - 1) + (rel[1] + ws - 1)).astype(np.int64)


class _Mlp(nn.Module):
    """fc1 → act → fc2, timm's `Mlp` names."""

    def __init__(self, dim: int, hidden: int, out: int, act):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, out)
        self.act = act

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class RelPosMlp(nn.Module):
    """'cr' mode: MLP(2 → 512 → heads, ReLU) over the log coords,
    gathered by relative position into a (heads, w², w²) bias."""

    def __init__(self, num_heads: int, window_size: int, hidden_dim: int = 512):
        super().__init__()
        self.num_heads, self.window_size = num_heads, window_size
        self.mlp = _Mlp(2, hidden_dim, num_heads, F.relu)
        self.register_buffer("rel_coords_log",
                             torch.from_numpy(_rel_log_coords(window_size)),
                             persistent=False)
        self.register_buffer("relative_position_index",
                             torch.from_numpy(_rel_index(window_size).reshape(-1)),
                             persistent=False)

    def forward(self):
        ws = self.window_size
        bias = self.mlp(self.rel_coords_log).reshape(-1, self.num_heads)
        bias = bias[self.relative_position_index]
        return bias.reshape(ws * ws, ws * ws, self.num_heads).permute(2, 0, 1)


class AttentionCl(nn.Module):
    """Channels-last multi-head attention: qkv packed per head
    [q | k | v], scale dim_head^−0.5, relative-position MLP bias,
    softmax in float32."""

    def __init__(self, dim: int, dim_head: int = 32, window_size: int = 7):
        super().__init__()
        self.dim_head = dim_head
        self.num_heads = dim // dim_head
        self.qkv = Linear(dim, 3 * dim)
        self.rel_pos = RelPosMlp(self.num_heads, window_size)
        self.proj = Linear(dim, dim)

    def forward(self, x):
        *lead, C = x.shape
        B = x.shape[0]
        nh, dh = self.num_heads, self.dim_head
        qkv = self.qkv(x).reshape(B, -1, nh, 3 * dh).transpose(1, 2)
        q, k, v = qkv[..., :dh], qkv[..., dh:2 * dh], qkv[..., 2 * dh:]
        attn = torch.matmul(q, k.transpose(-1, -2)) * scalar_in(dh ** -0.5, x.dtype)
        attn = attn + self.rel_pos()[None].to(attn.dtype)
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(*lead, C)
        return self.proj(out)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float):
        super().__init__()
        self.init_values = init_values
        self.gamma = nn.Parameter(torch.empty(dim))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.gamma.fill_(self.init_values)

    def forward(self, x):
        return x * self.gamma


class PartitionAttentionCl(nn.Module):
    """LN → block or grid partition → attention → reverse → layer scale;
    LN → MLP (GELU, ×4) → layer scale."""

    def __init__(self, dim: int, partition_type: str = "block",
                 window_size: int = 7, dim_head: int = 32,
                 init_values: float = 1e-6, expand_ratio: float = 4.0):
        super().__init__()
        if partition_type not in ("block", "grid"):
            raise ValueError(partition_type)
        self.partition_type, self.window_size = partition_type, window_size
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = AttentionCl(dim, dim_head, window_size)
        self.ls1 = LayerScale(dim, init_values)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim, int(dim * expand_ratio), dim, gelu)
        self.ls2 = LayerScale(dim, init_values)

    def forward(self, x):
        B, H, W, C = x.shape
        ws = self.window_size
        y = self.norm1(x)
        windows = B * (H // ws) * (W // ws)
        with profiling.span("dlka.maxvit.attention", partition=self.partition_type,
                            windows=windows):
            profiling.count("dlka.maxvit.windows", windows)
            if self.partition_type == "block":
                y = window_reverse(self.attn(window_partition(y, ws)), ws, H, W)
            else:
                y = grid_reverse(self.attn(grid_partition(y, ws)), ws, H, W)
        x = x + self.ls1(y)
        return x + self.ls2(self.mlp(self.norm2(x)))


class MaxxVitBlock(nn.Module):
    def __init__(self, in_chs: int, out_chs: int, stride: int = 1,
                 window_size: int = 7):
        super().__init__()
        self.conv = MbConv(in_chs, out_chs, stride=stride)
        self.attn_block = PartitionAttentionCl(out_chs, "block", window_size)
        self.attn_grid = PartitionAttentionCl(out_chs, "grid", window_size)

    def forward(self, x):
        return self.attn_grid(self.attn_block(self.conv(x)))


class Stem(nn.Module):
    """conv 3×3 s2 → BN + SiLU → conv 3×3, both convs bias-free."""

    def __init__(self, in_chs: int = 3, out_chs=(32, 64)):
        super().__init__()
        self.conv1 = Conv2d(in_chs, out_chs[0], 3, stride=2, padding=1, bias=False)
        self.norm1 = BNAct(out_chs[0])
        self.conv2 = Conv2d(out_chs[0], out_chs[1], 3, padding=1, bias=False)

    def forward(self, x):
        return self.conv2(self.norm1(self.conv1(x)))


class MaxxVitStage(nn.Module):
    def __init__(self, in_chs: int, out_chs: int, depth: int, window_size: int):
        super().__init__()
        self.blocks = nn.Sequential(*[
            MaxxVitBlock(in_chs if j == 0 else out_chs, out_chs,
                         stride=2 if j == 0 else 1, window_size=window_size)
            for j in range(depth)])

    def forward(self, x):
        return self.blocks(x)


class MaxViT4Out(nn.Module):
    """The four stage features (NHWC; dims at /4, /8, /16, /32); the last
    one LayerNorm-ed."""

    def __init__(self, embed_dims=(96, 192, 384, 768), depths=(2, 2, 5, 2),
                 img_size: int = 224, in_chs: int = 3, stem_chs=(32, 64)):
        super().__init__()
        ws = img_size // 32
        self.stem = Stem(in_chs, stem_chs)
        dims = (stem_chs[1],) + tuple(embed_dims)
        self.stages = nn.ModuleList([
            MaxxVitStage(dims[i], dims[i + 1], depth, ws)
            for i, depth in enumerate(depths)])
        self.norm = LayerNorm(embed_dims[-1], eps=1e-6)

    def forward(self, x):
        x = self.stem(x)
        feats = []
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        feats[-1] = self.norm(feats[-1])
        return feats
