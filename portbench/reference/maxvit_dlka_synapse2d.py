"""The 2D MaxViT D-LKA Net for Synapse, plain PyTorch, frozen.

The paper's 2D network (upstream `2D/`'s MaxViT deformable-LKA former):
the MaxViT-small rmlp encoder (stem 32/64; stages of 2/2/5/2 blocks at
dims 96/192/384/768; each block an MBConv with squeeze-excitation, then
block- and grid-partitioned attention over 7×7 windows with a
relative-position MLP bias, head dim 32, each with an MLP, layer scales;
the last feature LayerNorm-ed) and the deformable-LKA decoder (at /32 a
patch expansion; at /16, /8, /4 a linear map of the coarser feature plus
the skip, two deformable LKA blocks and a ×2, or at /4 a ×4, pixel
shuffle expansion; a 1×1 head to 9 classes).

A deformable LKA block: x + s₁·A(LN(x)), then + s₂·MLP(LN(x)), where
A(n) = proj_2(u · conv1(D₇(D₅(u)))) + n, u = GELU(proj_1(n)), Dₖ a
depthwise k×k deformable conv (D₇ with dilation 3) whose offsets a dense
conv of its input with the same kernel predicts, and MLP = fc2(GELU(dw3×3(fc1(·)))).

Functions take the parameters as a dict of tensors under the names the
program's `state_dict()` uses, and work channels-last (B, H, W, C) in
float32 (channels-first only inside each convolution). Each hand-kernel
site goes through `plain.KERNELS`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from portbench.reference import plain

DIMS = (96, 192, 384, 768)
DEPTHS = (2, 2, 5, 2)
STEM = (32, 64)
HEAD = 32
MLP_HIDDEN = 512
# the offsets' weights as the gates are driven: N(0, (s / sqrt(fan_in))²)
OFFSET_SCALE = {5: 3.0, 7: 10.0}


def _u(fan):
    return ("uniform", 1 / math.sqrt(fan))


def _make_divisible(v, divisor=8):
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    return new_v + divisor if new_v < 0.9 * v else new_v


def _norm_shapes(sh, name, C, batch=False):
    sh[f"{name}.weight"] = ((C,), ("const", 1.0))
    sh[f"{name}.bias"] = ((C,), ("const", 0.0))
    if batch:
        sh[f"{name}.running_mean"] = ((C,), ("const", 0.0))
        sh[f"{name}.running_var"] = ((C,), ("const", 1.0))


def _dense(sh, name, cout, cin, k=1, bias=True, conv=True):
    shape = (cout, cin, k, k) if conv else (cout, cin)
    sh[f"{name}.weight"] = (shape, _u(cin * k * k))
    if bias:
        sh[f"{name}.bias"] = ((cout,), _u(cin * k * k))


def _attn_shapes(sh, pre, C):
    _norm_shapes(sh, f"{pre}.norm1", C)
    _dense(sh, f"{pre}.attn.qkv", 3 * C, C, conv=False)
    _dense(sh, f"{pre}.attn.rel_pos.mlp.fc1", MLP_HIDDEN, 2, conv=False)
    _dense(sh, f"{pre}.attn.rel_pos.mlp.fc2", C // HEAD, MLP_HIDDEN, conv=False)
    _dense(sh, f"{pre}.attn.proj", C, C, conv=False)
    sh[f"{pre}.ls1.gamma"] = ((C,), ("const", 1.0))
    _norm_shapes(sh, f"{pre}.norm2", C)
    _dense(sh, f"{pre}.mlp.fc1", 4 * C, C, conv=False)
    _dense(sh, f"{pre}.mlp.fc2", C, 4 * C, conv=False)
    sh[f"{pre}.ls2.gamma"] = ((C,), ("const", 1.0))


def _mbconv_shapes(sh, pre, cin, cout, stride):
    mid = _make_divisible(cin * 4)
    if stride == 2 and cin != cout:
        _dense(sh, f"{pre}.shortcut.expand", cout, cin, bias=False)
    _norm_shapes(sh, f"{pre}.pre_norm", cin, batch=True)
    _dense(sh, f"{pre}.conv1_1x1", mid, cin, bias=False)
    _norm_shapes(sh, f"{pre}.norm1", mid, batch=True)
    sh[f"{pre}.conv2_kxk.weight"] = ((mid, 1, 3, 3), _u(9))
    _norm_shapes(sh, f"{pre}.norm2", mid, batch=True)
    rd = int(mid / 16)
    _dense(sh, f"{pre}.se.fc1", rd, mid)
    _dense(sh, f"{pre}.se.fc2", mid, rd)
    _dense(sh, f"{pre}.conv3_1x1", cout, mid, bias=False)


def _lka_shapes(sh, pre, C):
    sh[f"{pre}.layer_scale_1"] = ((C,), ("const", 1.0))
    sh[f"{pre}.layer_scale_2"] = ((C,), ("const", 1.0))
    _norm_shapes(sh, f"{pre}.norm1", C)
    a = f"{pre}.attn"
    _dense(sh, f"{a}.proj_1", C, C)
    for name, k in (("conv0", 5), ("conv_spatial", 7)):
        d = f"{a}.spatial_gating_unit.{name}"
        fan = C * k * k
        sh[f"{d}.offset_net.weight"] = ((2 * k * k, C, k, k), ("normal", OFFSET_SCALE[k] / math.sqrt(fan)))
        sh[f"{d}.offset_net.bias"] = ((2 * k * k,), _u(fan))
        sh[f"{d}.deform_conv.weight"] = ((C, 1, k, k), ("uniform", 1.0 / k))
    _dense(sh, f"{a}.spatial_gating_unit.conv1", C, C)
    _dense(sh, f"{a}.proj_2", C, C)
    _norm_shapes(sh, f"{pre}.norm2", C)
    _dense(sh, f"{pre}.mlp.fc1", 4 * C, C)
    sh[f"{pre}.mlp.dwconv.dwconv.weight"] = ((4 * C, 1, 3, 3), _u(9))
    sh[f"{pre}.mlp.dwconv.dwconv.bias"] = ((4 * C,), _u(9))
    _dense(sh, f"{pre}.mlp.fc2", C, 4 * C)


def param_shapes(cfg) -> dict:
    """name → (shape, init) of every tensor of the model's state."""
    sh = {}
    b = "backbone.backbone"
    sh[f"{b}.stem.conv1.weight"] = ((STEM[0], 3, 3, 3), _u(27))
    _norm_shapes(sh, f"{b}.stem.norm1", STEM[0], batch=True)
    sh[f"{b}.stem.conv2.weight"] = ((STEM[1], STEM[0], 3, 3), _u(9 * STEM[0]))
    dims = (STEM[1],) + DIMS
    for i, depth in enumerate(DEPTHS):
        for j in range(depth):
            pre = f"{b}.stages.{i}.blocks.{j}"
            cin = dims[i] if j == 0 else dims[i + 1]
            _mbconv_shapes(sh, f"{pre}.conv", cin, dims[i + 1], 2 if j == 0 else 1)
            _attn_shapes(sh, f"{pre}.attn_block", dims[i + 1])
            _attn_shapes(sh, f"{pre}.attn_grid", dims[i + 1])
    _norm_shapes(sh, f"{b}.norm", DIMS[3])
    _dense(sh, "decoder_3.layer_up.expand", 2 * DIMS[3], DIMS[3], bias=False, conv=False)
    _norm_shapes(sh, "decoder_3.layer_up.norm", DIMS[3] // 2)
    for n, C in ((2, 384), (1, 192), (0, 96)):
        pre = f"decoder_{n}"
        _dense(sh, f"{pre}.x1_linear", C, C, conv=False)
        _lka_shapes(sh, f"{pre}.layer_lka_1", C)
        _lka_shapes(sh, f"{pre}.layer_lka_2", C)
        if n:
            _dense(sh, f"{pre}.layer_up.expand", 2 * C, C, bias=False, conv=False)
            _norm_shapes(sh, f"{pre}.layer_up.norm", C // 2)
        else:
            _dense(sh, f"{pre}.layer_up.expand", 16 * C, C, bias=False, conv=False)
            _norm_shapes(sh, f"{pre}.layer_up.norm", C)
            _dense(sh, f"{pre}.last_layer", cfg["num_classes"], C)
    return sh


def is_param(name: str) -> bool:
    return not name.endswith(("running_mean", "running_var"))


def _conv(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride, padding, dilation, groups)
    return y.permute(0, 2, 3, 1)


def _bn(p, name, x, act=False):
    y = (x - p[f"{name}.running_mean"]) / torch.sqrt(p[f"{name}.running_var"] + 1e-5)
    y = y * p[f"{name}.weight"] + p[f"{name}.bias"]
    return F.silu(y) if act else y


def _ln(p, name, x, eps):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"], p[f"{name}.bias"], eps)


def _linear(p, name, x):
    return F.linear(x, p[f"{name}.weight"], p.get(f"{name}.bias"))


def _mbconv(p, pre, x, stride):
    if stride == 2:
        sc = F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        if f"{pre}.shortcut.expand.weight" in p:
            sc = _conv(sc, p[f"{pre}.shortcut.expand.weight"])
    else:
        sc = x
    y = _bn(p, f"{pre}.norm1", _conv(_bn(p, f"{pre}.pre_norm", x),
                                     p[f"{pre}.conv1_1x1.weight"]), act=True)
    w = p[f"{pre}.conv2_kxk.weight"]
    y = _bn(p, f"{pre}.norm2", _conv(y, w, None, stride, 1, 1, w.shape[0]), act=True)
    s = y.mean((1, 2), keepdim=True)
    s = _conv(F.silu(_conv(s, p[f"{pre}.se.fc1.weight"], p[f"{pre}.se.fc1.bias"])),
              p[f"{pre}.se.fc2.weight"], p[f"{pre}.se.fc2.bias"])
    y = y * torch.sigmoid(s)
    return _conv(y, p[f"{pre}.conv3_1x1.weight"]) + sc


def _rel_bias(p, pre, heads, ws):
    r = np.arange(-(ws - 1), ws, dtype=np.float32)
    table = np.stack(np.meshgrid(r, r, indexing="ij"), -1)
    table = np.sign(table) * np.log1p(np.abs(table))
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"), 0).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    index = (rel[0] + ws - 1) * (2 * ws - 1) + (rel[1] + ws - 1)
    dev = p[f"{pre}.mlp.fc1.weight"].device
    t = torch.from_numpy(table).to(dev).reshape(-1, 2)
    mlp = _linear(p, f"{pre}.mlp.fc2", F.relu(_linear(p, f"{pre}.mlp.fc1", t)))
    idx = torch.from_numpy(index.reshape(-1).astype(np.int64)).to(dev)
    return mlp[idx].reshape(ws * ws, ws * ws, heads).permute(2, 0, 1)


def _attention(p, pre, x, ws):
    """x (windows, ws, ws, C) → the same shape."""
    n, _, _, C = x.shape
    heads = C // HEAD
    qkv = _linear(p, f"{pre}.qkv", x).reshape(n, ws * ws, heads, 3 * HEAD).transpose(1, 2)
    q, k, v = qkv.split(HEAD, dim=-1)
    a = q @ k.transpose(-1, -2) * HEAD ** -0.5 + _rel_bias(p, f"{pre}.rel_pos", heads, ws)
    out = (torch.softmax(a, -1) @ v).transpose(1, 2).reshape(n, ws, ws, C)
    return _linear(p, f"{pre}.proj", out)


def _partition_attention(p, pre, x, kind, ws):
    B, H, W, C = x.shape
    y = _ln(p, f"{pre}.norm1", x, 1e-6)
    if kind == "block":   # windows of neighbouring pixels
        y = y.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
        y = _attention(p, f"{pre}.attn", y.reshape(-1, ws, ws, C), ws)
        y = y.reshape(B, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    else:                 # a grid of pixels H/ws apart
        y = y.reshape(B, ws, H // ws, ws, W // ws, C).permute(0, 2, 4, 1, 3, 5)
        y = _attention(p, f"{pre}.attn", y.reshape(-1, ws, ws, C), ws)
        y = y.reshape(B, H // ws, W // ws, ws, ws, C).permute(0, 3, 1, 4, 2, 5)
    x = x + p[f"{pre}.ls1.gamma"] * y.reshape(B, H, W, C)
    h = _linear(p, f"{pre}.mlp.fc2", F.gelu(_linear(p, f"{pre}.mlp.fc1", _ln(p, f"{pre}.norm2", x, 1e-6))))
    return x + p[f"{pre}.ls2.gamma"] * h


def encoder(p, cfg, x):
    b = "backbone.backbone"
    ws = cfg["img_size"] // 32
    x = _conv(x, p[f"{b}.stem.conv1.weight"], None, 2, 1)
    x = _conv(_bn(p, f"{b}.stem.norm1", x, act=True), p[f"{b}.stem.conv2.weight"], None, 1, 1)
    feats = []
    for i, depth in enumerate(DEPTHS):
        for j in range(depth):
            pre = f"{b}.stages.{i}.blocks.{j}"
            x = _mbconv(p, f"{pre}.conv", x, 2 if j == 0 else 1)
            x = _partition_attention(p, f"{pre}.attn_block", x, "block", ws)
            x = _partition_attention(p, f"{pre}.attn_grid", x, "grid", ws)
        feats.append(x)
    feats[-1] = _ln(p, f"{b}.norm", feats[-1], 1e-6)
    return feats


def _deform(p, pre, x, k, dil):
    pad = (k // 2) * dil
    off = _conv(x, p[f"{pre}.offset_net.weight"], p[f"{pre}.offset_net.bias"], 1, pad, dil)
    y = plain.KERNELS["deform_dw_conv2d"](x.permute(0, 3, 1, 2), off.permute(0, 3, 1, 2),
                                         p[f"{pre}.deform_conv.weight"], dil)
    return y.permute(0, 2, 3, 1)


def lka_block(p, pre, x):
    a = f"{pre}.attn"
    g = f"{a}.spatial_gating_unit"
    n = _ln(p, f"{pre}.norm1", x, 1e-5)
    u = F.gelu(_conv(n, p[f"{a}.proj_1.weight"], p[f"{a}.proj_1.bias"]))
    d = _deform(p, f"{g}.conv_spatial", _deform(p, f"{g}.conv0", u, 5, 1), 7, 3)
    y = _conv(u * _conv(d, p[f"{g}.conv1.weight"], p[f"{g}.conv1.bias"]),
              p[f"{a}.proj_2.weight"], p[f"{a}.proj_2.bias"]) + n
    x = x + p[f"{pre}.layer_scale_1"] * y
    m = _conv(_ln(p, f"{pre}.norm2", x, 1e-5), p[f"{pre}.mlp.fc1.weight"], p[f"{pre}.mlp.fc1.bias"])
    w = p[f"{pre}.mlp.dwconv.dwconv.weight"]
    m = F.gelu(_conv(m, w, p[f"{pre}.mlp.dwconv.dwconv.bias"], 1, 1, 1, w.shape[0]))
    m = _conv(m, p[f"{pre}.mlp.fc2.weight"], p[f"{pre}.mlp.fc2.bias"])
    return x + p[f"{pre}.layer_scale_2"] * m


def _expand(p, pre, x, r):
    B, H, W, _ = x.shape
    y = _linear(p, f"{pre}.expand", x)
    y = y.reshape(B, H, W, r, r, y.shape[-1] // (r * r))
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(B, r * H, r * W, -1)
    return _ln(p, f"{pre}.norm", y, 1e-5)


def forward_cl(p, cfg, x, remat=False):
    """x (B, H, W, 1) → logits (B, H, W, classes). `remat` recomputes each
    deformable LKA block in the backward pass (the reference's memory, not
    its arithmetic)."""
    def lka(pre, t):
        if remat:
            return torch.utils.checkpoint.checkpoint(lka_block, p, pre, t, use_reentrant=False)
        return lka_block(p, pre, t)

    e0, e1, e2, e3 = encoder(p, cfg, x.expand(*x.shape[:3], 3))
    t = _expand(p, "decoder_3.layer_up", e3, 2)
    for n, skip in ((2, e2), (1, e1), (0, e0)):
        pre = f"decoder_{n}"
        t = lka(f"{pre}.layer_lka_1", _linear(p, f"{pre}.x1_linear", t) + skip)
        t = lka(f"{pre}.layer_lka_2", t)
        t = _expand(p, f"{pre}.layer_up", t, 2 if n else 4)
    return _conv(t, p["decoder_0.last_layer.weight"], p["decoder_0.last_layer.bias"])


def loss(p, cfg, image, label, remat=False):
    """0.4·CE + 0.6·Dice (the 2D trainer's loss); image (B, H, W, 1)."""
    return plain.dice_ce_2d_loss(forward_cl(p, cfg, image, remat).permute(0, 3, 1, 2), label)
