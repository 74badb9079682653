"""Swin UNETR for BTCV, plain PyTorch, frozen.

Tang et al., CVPR 2022 (arXiv 2111.14791), as MONAI's
`monai/networks/nets/swin_unetr.py` computes `SwinUNETR(img_size=96³,
in_channels=1, out_channels=14, feature_size=48)`: a 2³ stride-2 conv
embeds patches; four Swin stages (depths 2/2/2/2, heads 3/6/12/24, dims
F·2^i) each end in a patch merging; every hidden state is layer-normed
without affine; MONAI's dynunet residual blocks decode.

A Swin block: y = LN₁(x) padded with zeros to whole windows; in the odd
blocks rolled by −3 on each axis; per window, softmax(q·kᵀ/√d + B + M)·v
per head, then `proj`; rolled back by +3 and cropped; x + y, then
x + linear2(GELU(linear1(LN₂(x)))). Along an axis where the map is not
larger than 7, the window is the map's size and the shift 0.
B: a (13³, heads) table read at (Δd+6)·169 + (Δh+6)·13 + (Δw+6), where
token t of a window sits at the t-th place of a 7³ window, row-major:
also where the window is clamped to a smaller map, as MONAI indexes
(`relative_position_index[:n, :n]`). M: −100 between tokens of a window
from different regions of the padded map, the regions cut along each
axis at size − 7 and size − 3. Patch merging: the eight 2×2×2
neighbours in `itertools.product` order (MONAI's `PatchMergingV2`), LN,
a bias-free linear 8C → 2C.

Written apart from the program: each window's attention by slicing the
rolled, padded map, the windows put back by concatenation; the bias from
the tokens' offsets by formula; the mask from the region labels.
Functions take the parameters as a dict of tensors under the program's
`state_dict()` names; the decoder works channels-first, the transformer
channels-last, all in float32.
"""

from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from portbench.reference import plain

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MASKED = -100.0


def _u(fan):
    return ("uniform", 1 / math.sqrt(fan))


def _block_shapes(b, C, heads, window):
    one, zero = ("const", 1.0), ("const", 0.0)
    return {f"{b}.norm1.weight": ((C,), one), f"{b}.norm1.bias": ((C,), zero),
            # drawn N(0, 1), so that a wrong index, shift or mask moves the loss
            f"{b}.attn.relative_position_bias_table": (((2 * window - 1) ** 3, heads),
                                                       ("normal", 1.0)),
            f"{b}.attn.qkv.weight": ((3 * C, C), _u(C)), f"{b}.attn.qkv.bias": ((3 * C,), _u(C)),
            f"{b}.attn.proj.weight": ((C, C), _u(C)), f"{b}.attn.proj.bias": ((C,), _u(C)),
            f"{b}.norm2.weight": ((C,), one), f"{b}.norm2.bias": ((C,), zero),
            f"{b}.mlp.linear1.weight": ((4 * C, C), _u(C)),
            f"{b}.mlp.linear1.bias": ((4 * C,), _u(C)),
            f"{b}.mlp.linear2.weight": ((C, 4 * C), _u(4 * C)),
            f"{b}.mlp.linear2.bias": ((C,), _u(4 * C))}


def _res_shapes(pre, cin, cout):
    sh = {f"{pre}.conv1.conv.weight": ((cout, cin, 3, 3, 3), _u(27 * cin)),
          f"{pre}.conv2.conv.weight": ((cout, cout, 3, 3, 3), _u(27 * cout))}
    if cin != cout:
        sh[f"{pre}.conv3.conv.weight"] = ((cout, cin, 1, 1, 1), _u(cin))
    return sh


def param_shapes(cfg) -> dict:
    """name → (shape, init) of every tensor of the model's state, init
    ("uniform", bound), ("normal", std) or ("const", value)."""
    fs, cin, ncls = cfg["feature_size"], cfg["in_channels"], cfg["num_classes"]
    window = cfg["window_size"]
    sh = {"swinViT.patch_embed.proj.weight": ((fs, cin, 2, 2, 2), _u(8 * cin)),
          "swinViT.patch_embed.proj.bias": ((fs,), _u(8 * cin))}
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        C = fs * 2 ** i
        pre = f"swinViT.layers{i + 1}.0"
        for j in range(depth):
            sh.update(_block_shapes(f"{pre}.blocks.{j}", C, heads, window))
        sh[f"{pre}.downsample.norm.weight"] = ((8 * C,), ("const", 1.0))
        sh[f"{pre}.downsample.norm.bias"] = ((8 * C,), ("const", 0.0))
        sh[f"{pre}.downsample.reduction.weight"] = ((2 * C, 8 * C), _u(8 * C))
    sh.update(_res_shapes("encoder1.layer", cin, fs))
    for name, c in (("encoder2", fs), ("encoder3", 2 * fs), ("encoder4", 4 * fs),
                    ("encoder10", 16 * fs)):
        sh.update(_res_shapes(f"{name}.layer", c, c))
    for name, c_in, c_out in (("decoder5", 16 * fs, 8 * fs), ("decoder4", 8 * fs, 4 * fs),
                              ("decoder3", 4 * fs, 2 * fs), ("decoder2", 2 * fs, fs),
                              ("decoder1", fs, fs)):
        sh[f"{name}.transp_conv.conv.weight"] = ((c_in, c_out, 2, 2, 2), _u(8 * c_in))
        sh.update(_res_shapes(f"{name}.conv_block", 2 * c_out, c_out))
    sh["out.conv.conv.weight"] = ((ncls, fs, 1, 1, 1), _u(fs))
    sh["out.conv.conv.bias"] = ((ncls,), _u(fs))
    return sh


# ---------------------------------------------------------------- the Swin encoder


def _ln(p, name, x):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"], p[f"{name}.bias"], 1e-5)


def _linear(p, name, x):
    return F.linear(x, p[f"{name}.weight"], p.get(f"{name}.bias"))


def relative_bias(table, n, window, device):
    """(heads, n, n): the table at the offset of tokens i and j, token t at
    place (t // w², t // w mod w, t mod w) of a w³ window."""
    t = torch.arange(n, device=device)
    place = torch.stack([t // window ** 2, t // window % window, t % window])
    off = place[:, :, None] - place[:, None, :] + (window - 1)
    return table[(off[0] * (2 * window - 1) + off[1]) * (2 * window - 1) + off[2]].permute(2, 0, 1)


def region_labels(size, ws, shift, device):
    """(D, H, W): per voxel of the padded map, its region along each axis
    (0 before the last window, 1 in the last window up to the last `shift`
    voxels, 2 in those; one region where there is no shift), as one number."""
    axes = []
    for n, w, s in zip(size, ws, shift):
        i = torch.arange(n, device=device)
        axes.append(torch.where(i < n - w, 0, torch.where(i < n - s, 1, 2)) if s
                    else torch.zeros_like(i))
    return axes[0][:, None, None] * 9 + axes[1][None, :, None] * 3 + axes[2][None, None, :]


def _attention(p, b, y, ws, shift, heads, window):
    """Window attention over the padded, normed map y (B, Dp, Hp, Wp, C),
    window by window."""
    B, Dp, Hp, Wp, C = y.shape
    n, hd = math.prod(ws), C // heads
    rolled = any(shift)
    if rolled:
        y = torch.roll(y, [-s for s in shift], (1, 2, 3))
        labels = region_labels((Dp, Hp, Wp), ws, shift, y.device)
    bias = relative_bias(p[f"{b}.attn.relative_position_bias_table"], n, window, y.device)
    planes = []
    for d in range(0, Dp, ws[0]):
        rows = []
        for h in range(0, Hp, ws[1]):
            cells = []
            for w in range(0, Wp, ws[2]):
                win = (slice(d, d + ws[0]), slice(h, h + ws[1]), slice(w, w + ws[2]))
                t = y[(slice(None),) + win].reshape(B, n, C)
                q, k, v = _linear(p, f"{b}.attn.qkv", t).reshape(B, n, 3, heads, hd).unbind(2)
                q, k, v = (z.transpose(1, 2) for z in (q, k, v))
                s = q @ k.transpose(-1, -2) * hd ** -0.5 + bias
                if rolled:
                    lab = labels[win].reshape(n)
                    s = s + torch.where(lab[:, None] != lab[None, :], MASKED, 0.0)
                o = (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(B, n, C)
                cells.append(_linear(p, f"{b}.attn.proj", o).reshape(B, *ws, C))
            rows.append(torch.cat(cells, 3))
        planes.append(torch.cat(rows, 2))
    out = torch.cat(planes, 1)
    return torch.roll(out, list(shift), (1, 2, 3)) if rolled else out


def block(p, b, x, ws, shift, heads, window):
    B, D, H, W, C = x.shape
    pads = [(-s) % w for s, w in zip((D, H, W), ws)]
    y = F.pad(_ln(p, f"{b}.norm1", x), (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
    x = x + _attention(p, b, y, ws, shift, heads, window)[:, :D, :H, :W]
    z = F.gelu(_linear(p, f"{b}.mlp.linear1", _ln(p, f"{b}.norm2", x)))
    return x + _linear(p, f"{b}.mlp.linear2", z)


def _merge(p, pre, x):
    _, D, H, W, _ = x.shape
    x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2, 0, D % 2))
    x = torch.cat([x[:, i::2, j::2, k::2] for i, j, k in itertools.product((0, 1), repeat=3)],
                  -1)
    return F.linear(_ln(p, f"{pre}.norm", x), p[f"{pre}.reduction.weight"])


def _stage(p, i, x, cfg, remat):
    pre = f"swinViT.layers{i + 1}.0"
    window, heads = cfg["window_size"], cfg["num_heads"][i]
    size = x.shape[1:4]
    ws = tuple(min(s, window) for s in size)
    half = tuple(0 if s <= window else window // 2 for s in size)
    for j in range(cfg["depths"][i]):
        args = (p, f"{pre}.blocks.{j}", x, ws, half if j % 2 else (0, 0, 0), heads, window)
        if remat:
            x = torch.utils.checkpoint.checkpoint(block, *args, use_reentrant=False)
        else:
            x = block(*args)
    return _merge(p, f"{pre}.downsample", x)


def _normed(x):
    return F.layer_norm(x, (x.shape[-1],))


# ---------------------------------------------------------------- the decoder


def _lrelu(x):
    return F.leaky_relu(x, 0.01)


def _inorm(x):
    """Instance norm without affine, eps 1e-5 (also over one voxel, which
    `F.instance_norm` refuses)."""
    m = x.mean((2, 3, 4), keepdim=True)
    v = (x - m).square().mean((2, 3, 4), keepdim=True)
    return (x - m) / torch.sqrt(v + 1e-5)


def _res_block(p, pre, x):
    """MONAI's UnetResBlock, stride 1, instance norm without affine:
    conv-norm-lrelu-conv-norm, plus x (or its 1³ projection, normed, when
    the channels change), lrelu."""
    y = _lrelu(_inorm(F.conv3d(x, p[f"{pre}.conv1.conv.weight"], padding=1)))
    y = _inorm(F.conv3d(y, p[f"{pre}.conv2.conv.weight"], padding=1))
    if f"{pre}.conv3.conv.weight" in p:
        x = _inorm(F.conv3d(x, p[f"{pre}.conv3.conv.weight"]))
    return _lrelu(y + x)


def _up(p, pre, x, skip):
    y = F.conv_transpose3d(x, p[f"{pre}.transp_conv.conv.weight"], stride=2)
    return _res_block(p, f"{pre}.conv_block", torch.cat([y, skip], 1))


def forward(p, cfg, x, remat=False):
    """x (B, Cin, *img_size) → logits (B, classes, *img_size). `remat`
    recomputes each Swin block in the backward pass (the reference's
    memory, not its arithmetic)."""
    t = F.conv3d(x, p["swinViT.patch_embed.proj.weight"], p["swinViT.patch_embed.proj.bias"],
                 stride=2).movedim(1, -1)
    hidden = [_normed(t)]
    for i in range(len(cfg["depths"])):
        t = _stage(p, i, t, cfg, remat)
        hidden.append(_normed(t))
    hs = [h.movedim(-1, 1) for h in hidden]
    enc0 = _res_block(p, "encoder1.layer", x)
    enc1 = _res_block(p, "encoder2.layer", hs[0])
    enc2 = _res_block(p, "encoder3.layer", hs[1])
    enc3 = _res_block(p, "encoder4.layer", hs[2])
    dec = _res_block(p, "encoder10.layer", hs[4])
    for name, skip in (("decoder5", hs[3]), ("decoder4", enc3), ("decoder3", enc2),
                       ("decoder2", enc1), ("decoder1", enc0)):
        dec = _up(p, name, dec, skip)
    return F.conv3d(dec, p["out.conv.conv.weight"], p["out.conv.conv.bias"])


def loss(p, cfg, image, label, remat=False):
    """Dice + CE of the one output (no deep supervision); image (B, *S, 1),
    label (B, *S)."""
    logits = forward(p, cfg, image.movedim(-1, 1), remat)
    return plain.cross_entropy(logits, label) + plain.soft_dice_batch(logits, label)


def is_param(name: str) -> bool:
    """Every entry of the state is a trained parameter."""
    return True
