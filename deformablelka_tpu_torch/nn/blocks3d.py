"""The 3D block family's inner modules, channels-last (B, D, H, W, C) or
tokens (B, N, C).

Port of `deformablelka_tpu/nn/blocks3d.py`:

- the gates, each `u · conv1(...)` inside `GatedAttention3d` (proj_1 →
  GELU → gate → proj_2, plus the shortcut): `LKA3d` (dw5³ → dw7³-dil3),
  `LKA3dDeform` (the published gate, then `DeformConvPack3d`),
  `LKA3dConv` (a plain 3³ conv where the deform conv was),
  `LKA3dDeformACDC` (dim-dependent anisotropic kernels) and
  `LKA3dDeformSizeAware` (dim-dependent kernels of the `*_sequential`
  blocks);
- the token attentions `EPA`, `EfficientAttention`,
  `ChannelOnlyAttention` and `SpatialOnlyAttention`;
- `SliceDeformableLKA2d`, the 2D deformable LKA of each depth slice.

Every dw5³ → dw7³-dil3 pair runs as one call of `ops.kernels.dw_chain3d`,
every 3³ deform conv as one call of `ops.kernels.deform_conv3d`, every
dilated depthwise K³ conv that the JAX package sends to its Pallas kernel
(`ops.dwconv3d.dwconv3d_site`) as one call of `ops.kernels.dwconv3d`, and
every 2D depthwise deform conv as one call of `ops.kernels.deform_dw_conv2d`:
the hand kernels on a CUDA tensor, their plain versions on a CPU tensor.
Modules hold their weights in torch's layout and upstream's attribute
names, and hand the kernels the JAX layout.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from deformablelka_tpu_torch.nn.layers import Conv2d, Conv3d, Linear, _uniform_, gelu
from deformablelka_tpu_torch.nn.lka2d import DeformDwWeight
from deformablelka_tpu_torch.nn.lka2d import _jax_layout as _jax_layout2d
from deformablelka_tpu_torch.nn.norms import LayerNorm
from deformablelka_tpu_torch.ops import kernels
from deformablelka_tpu_torch.ops.dwconv3d import dwconv3d_site


def _jax_layout(w):
    """(Cout, Cin/g, kd, kh, kw) → contiguous (kd, kh, kw, Cin/g, Cout)."""
    return w.permute(2, 3, 4, 1, 0).contiguous()


class DeformConvPack3d(nn.Module):
    """3³ deformable conv (stride 1, pad 1) whose offsets a 3³ conv
    (`conv_offset`, 81 channels: (Δd, Δh, Δw) per tap) predicts.

    Init, as the JAX package: the deform weight U(±1/sqrt(27·C)), its bias
    0; the offset conv's weight 0 and its bias torch's default
    U(±1/sqrt(27·C)). So at init every voxel samples at the same
    non-integer offset per tap, and the offset gradient is not zero.
    """

    def __init__(self, dim: int):
        super().__init__()
        self.conv_offset = Conv3d(dim, 81, 3, padding=1)
        self.weight = nn.Parameter(torch.empty(dim, dim, 3, 3, 3))
        self.bias = nn.Parameter(torch.empty(dim))

    def reset_parameters(self, generator=None):
        # runs after conv_offset's own reset (init_parameters' order)
        with torch.no_grad():
            self.conv_offset.weight.zero_()
            self.bias.zero_()
        _uniform_(self.weight, 1.0 / math.sqrt(27 * self.weight.shape[1]),
                  generator)

    def forward(self, x):
        offsets = self.conv_offset(x).contiguous()
        return kernels.deform_conv3d(x.contiguous(), offsets,
                                     _jax_layout(self.weight), self.bias)


def _dw_pair3d(x, conv0: Conv3d, conv_spatial: Conv3d):
    """dw5³ → dw7³-dil3 with their biases, as one fused chain."""
    return kernels.dw_chain3d(x.contiguous(), _jax_layout(conv0.weight),
                              conv0.bias, _jax_layout(conv_spatial.weight),
                              conv_spatial.bias)


# (k_dw, p_dw, k_dwd, dil, p_dwd) of the dw5³ → dw7³-dil3 pair
_PUBLISHED = (5, 2, 7, 3, 9)


class LKA3d(nn.Module):
    """The plain 3D LKA gate: u · conv1(dw7d3(dw5(u))).

    Its subclasses set `table` (dim → (k_dw, p_dw, k_dwd, dil, p_dwd);
    None: the dw5³ → dw7³-dil3 pair at every dim) and the conv that
    `_deform_conv` builds between the pair and conv1. The pair runs as the
    fused chain; a `conv_spatial` that the JAX package sends to its
    dilated depthwise Pallas kernel (`dwconv3d_site`) runs as
    `kernels.dwconv3d`; any other conv on `F.conv3d`."""

    table = None

    def __init__(self, dim: int):
        super().__init__()
        spec = _PUBLISHED if self.table is None else self.table.get(dim)
        if spec is None:
            raise ValueError(f"unsupported dim {dim}")
        k_dw, p_dw, k_dwd, dil, p_dwd = spec
        self.pair = spec == _PUBLISHED
        self.conv0 = Conv3d(dim, dim, k_dw, padding=p_dw, groups=dim)
        self.conv_spatial = Conv3d(dim, dim, k_dwd, padding=p_dwd,
                                   dilation=dil, groups=dim)
        w = self.conv_spatial.weight
        self.site = not self.pair and dwconv3d_site(
            (*w.shape[2:], w.shape[1], w.shape[0]), 1, p_dwd, dil, dim, dim)
        self.deform_conv = self._deform_conv(dim)
        self.conv1 = Conv3d(dim, dim, 1)

    def _deform_conv(self, dim: int):
        return None

    def forward(self, x):
        if self.pair:
            attn = _dw_pair3d(x, self.conv0, self.conv_spatial)
        elif self.site:
            cs = self.conv_spatial
            attn = kernels.dwconv3d(self.conv0(x).contiguous(),
                                    _jax_layout(cs.weight), cs.bias,
                                    cs.dilation)
        else:
            attn = self.conv_spatial(self.conv0(x))
        if self.deform_conv is not None:
            attn = self.deform_conv(attn)
        return x * self.conv1(attn)


class LKA3dConv(LKA3d):
    """Ablation: a plain 3³ conv where the published gate has its deform
    conv; upstream names it `deform_conv`."""

    def _deform_conv(self, dim: int):
        return Conv3d(dim, dim, 3, padding=1)


class LKA3dDeform(LKA3d):
    """The published 3D D-LKA gate: u · conv1(deform(dw7d3(dw5(u))))."""

    def _deform_conv(self, dim: int):
        return DeformConvPack3d(dim)


class LKA3dDeformSizeAware(LKA3dDeform):
    """The gate of the `*_sequential` blocks: dw5³ → dw7³-dil3 at dims 32
    and 64 (the fused chain), dw5³ → dw5³-dil3 at 128 and dw3³ → dw3³-dil2
    at 256 (the dilated conv on `kernels.dwconv3d`)."""

    table = {32: _PUBLISHED, 64: _PUBLISHED,
             128: (5, 2, 5, 3, 6), 256: (3, 1, 3, 2, 2)}


class LKA3dDeformACDC(LKA3dDeform):
    """The ACDC gate: anisotropic dilated kernels, shallow along depth
    (dims 32/64: dw5³ → dw(5,7,7) dil 3; 128: dw5³ → dw(3,5,5) dil
    (1,3,3); 256: dw3³ → dw3³ dil 1). None is a kernel site; all run on
    `F.conv3d`, as they run on XLA's conv in the JAX package."""

    table = {32: (5, 2, (5, 7, 7), 3, (6, 9, 9)),
             64: (5, 2, (5, 7, 7), 3, (6, 9, 9)),
             128: (5, 2, (3, 5, 5), (1, 3, 3), (1, 6, 6)),
             256: (3, 1, 3, 1, 1)}


class GatedAttention3d(nn.Module):
    """proj_1 → GELU → gating unit → proj_2, plus the shortcut."""

    def __init__(self, dim: int, gate=LKA3dDeform):
        super().__init__()
        self.proj_1 = Conv3d(dim, dim, 1)
        self.spatial_gating_unit = gate(dim)
        self.proj_2 = Conv3d(dim, dim, 1)

    def forward(self, x):
        y = gelu(self.proj_1(x))
        y = self.spatial_gating_unit(y)
        return self.proj_2(y) + x


# ---------------------------------------------------------------------------
# The 2D deformable LKA of each depth slice
# ---------------------------------------------------------------------------

class DeformConv2dSlice(nn.Module):
    """Depthwise k×k deformable conv whose offsets a 3×3 pad-1 conv
    (`offset_net`) predicts, whatever k is; its bias-free weight is
    `deform_conv.weight` (C, 1, k, k)."""

    def __init__(self, channels: int, kernel_size: int, padding: int,
                 dilation: int = 1):
        super().__init__()
        if padding != (kernel_size // 2) * dilation:
            raise ValueError("only 'same' padding is ported")
        self.dilation = dilation
        self.offset_net = Conv2d(channels, 2 * kernel_size ** 2, 3, padding=1)
        self.deform_conv = DeformDwWeight(channels, kernel_size)

    def forward(self, x):
        return kernels.deform_dw_conv2d(
            x.contiguous(), self.offset_net(x).contiguous(),
            _jax_layout2d(self.deform_conv.weight), self.dilation)


class _SliceGate(nn.Module):
    """u · conv1(deform 7²-dil3(deform 5²(u)))."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv0 = DeformConv2dSlice(dim, 5, padding=2)
        self.conv_spatial = DeformConv2dSlice(dim, 7, padding=9, dilation=3)
        self.conv1 = Conv2d(dim, dim, 1)

    def forward(self, x):
        return x * self.conv1(self.conv_spatial(self.conv0(x)))


class SliceDeformableLKA2d(nn.Module):
    """proj_1 → GELU → the 2D deformable LKA gate → proj_2, plus the
    shortcut, on every slice along S3 of (B, S1, S2, S3, C): the slices
    fold into the batch, so each deform conv is one kernel call."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj_1 = Conv2d(dim, dim, 1)
        self.spatial_gating_unit = _SliceGate(dim)
        self.proj_2 = Conv2d(dim, dim, 1)

    def forward(self, x):
        B, S1, S2, S3, C = x.shape
        y = x.permute(0, 3, 1, 2, 4).reshape(B * S3, S1, S2, C)
        y = self.proj_2(self.spatial_gating_unit(gelu(self.proj_1(y))))
        return y.reshape(B, S3, S1, S2, C).permute(0, 2, 3, 1, 4) + x


# ---------------------------------------------------------------------------
# Token attentions, on (B, N, C)
# ---------------------------------------------------------------------------

def _l2norm(x, eps: float = 1e-12):
    """F.normalize over the last axis: x / max(‖x‖, eps)."""
    return x / x.norm(dim=-1, keepdim=True).clamp_min(eps)


def _softmax(x, dim: int = -1):
    return F.softmax(x.float(), dim=dim).to(x.dtype)


def _heads(t, n: int, h: int):
    """A Linear's output (B, N, n·C), laid out (n, h, C/h) → n tensors
    (B, h, C/h, N)."""
    B, N, nC = t.shape
    return t.reshape(B, N, n, h, nC // (n * h)).permute(2, 0, 3, 4, 1).unbind(0)


def _to_tokens(t, C: int):
    """(B, h, a, b) → (B, N, C) as the reference's `permute(0, 3, 1,
    2).reshape(B, N, C)`: on the channel branch (a = C/h, b = N) the
    tokens; on the spatial branch (a = N, b = C/h) a reinterpretation of
    the (C/h, h, N) layout, kept."""
    return t.permute(0, 3, 1, 2).reshape(t.shape[0], -1, C)


def _channel_attention(m, x):
    """Channel attention of `m.qkv`, `m.temperature`: (C/h)² per head."""
    q, k, v = _heads(m.qkv(x), 3, m.num_heads)
    attn = _softmax(_l2norm(q) @ _l2norm(k).transpose(-2, -1) * m.temperature)
    return _to_tokens(attn @ v, x.shape[-1])


def _spatial_attention(m, x):
    """Spatial attention of `m.qkv`, `m.E`, `m.temperature`: k and v are
    projected from N tokens to `proj_size` by the one Linear E, on the
    (B, h, C/h, N) layout."""
    q, k, v = _heads(m.qkv(x), 3, m.num_heads)
    attn = _softmax(_l2norm(q).transpose(-2, -1) @ m.E(k) * m.temperature)
    return _to_tokens(attn @ m.E(v).transpose(-2, -1), x.shape[-1])


def _init_channel_attention(m, C: int, num_heads: int):
    m.num_heads = num_heads
    m.qkv = Linear(C, 3 * C, bias=False)
    m.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))


def _init_spatial_attention(m, C: int, num_heads: int, input_size: int,
                            proj_size: int):
    _init_channel_attention(m, C, num_heads)
    m.E = Linear(input_size, proj_size)


class ChannelOnlyAttention(nn.Module):
    """qkv → l2-normalised q, k → softmax((C/h)² map · temperature) · v."""

    def __init__(self, hidden_size: int, num_heads: int = 4):
        super().__init__()
        _init_channel_attention(self, hidden_size, num_heads)

    def forward(self, x):
        return _channel_attention(self, x)


class SpatialOnlyAttention(nn.Module):
    """qkv → l2-normalised q against E(k) → softmax(· temperature) · E(v)."""

    def __init__(self, input_size: int, hidden_size: int, proj_size: int,
                 num_heads: int = 4):
        super().__init__()
        _init_spatial_attention(self, hidden_size, num_heads, input_size,
                                proj_size)

    def forward(self, x):
        return _spatial_attention(self, x)


class EPA(nn.Module):
    """Efficient Paired Attention: shared q, k; channel attention and
    spatial attention (k, v projected by E), each out-projected to C/2,
    concatenated (spatial first)."""

    def __init__(self, input_size: int, hidden_size: int, proj_size: int,
                 num_heads: int = 4):
        super().__init__()
        C = hidden_size
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.temperature2 = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkvv = Linear(C, 4 * C, bias=False)
        self.E = Linear(input_size, proj_size)
        self.out_proj = Linear(C, C // 2)
        self.out_proj2 = Linear(C, C // 2)

    def forward(self, x):
        q, k, v_ca, v_sa = _heads(self.qkvv(x), 4, self.num_heads)
        qn, kn = _l2norm(q), _l2norm(k)
        attn_ca = _softmax(qn @ kn.transpose(-2, -1) * self.temperature)
        x_ca = _to_tokens(attn_ca @ v_ca, x.shape[-1])
        attn_sa = _softmax(qn.transpose(-2, -1) @ self.E(k) * self.temperature2)
        x_sa = _to_tokens(attn_sa @ self.E(v_sa).transpose(-2, -1), x.shape[-1])
        return torch.cat([self.out_proj(x_sa), self.out_proj2(x_ca)], -1)


class EfficientAttention(nn.Module):
    """Linear attention: softmax(k) over tokens, softmax(q) over each
    head's channels, context k·vᵀ, then `reprojection`."""

    def __init__(self, hidden_size: int, num_heads: int = 4):
        super().__init__()
        C = hidden_size
        self.num_heads = num_heads
        self.query_lin = Linear(C, C, bias=False)
        self.key_lin = Linear(C, C, bias=False)
        self.value_lin = Linear(C, C, bias=False)
        self.reprojection = Linear(C, C)

    def forward(self, x):
        B, N, C = x.shape
        h = self.num_heads

        def heads(lin):
            return lin(x).transpose(1, 2).reshape(B, h, C // h, N)

        k = _softmax(heads(self.key_lin), -1)
        q = _softmax(heads(self.query_lin), -2)
        context = k @ heads(self.value_lin).transpose(-2, -1)
        att = (context.transpose(-2, -1) @ q).reshape(B, C, N).transpose(1, 2)
        return self.reprojection(att)
