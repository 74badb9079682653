"""The 3D D-LKA Former for Synapse, plain PyTorch, frozen.

The network of arXiv 2309.00121 as upstream's
`3D/d_lka_former/network_architecture/synapse/d_lka_former_synapse.py`
builds it with `TransformerBlock_3D_single_deform_LKA` in every stage:
a (2, 4, 4) patch stem and three stride-2 downsamples (each a conv and a
GroupNorm) feed four stages of three blocks at dims 32/64/128/256; three
up-blocks (transposed conv, additive skip, three blocks) and a conv
decoder (transposed conv, skip from `encoder1`, a residual block with
instance norm) return to the input's size; 1³ heads give the logits at
full, 1/2 and 1/4 size (deep supervision).

A block: tokens t = flatten(x) + pos_embed; n = LayerNorm(t);
u = GELU(proj_1(n)); a = deform3³(dw7³-dil3(dw5³(u))), its offsets from a
3³ conv of its input; g = proj_2(u · conv1(a)) + n; y = t + γ·g;
out = y + conv8(ResBlock_bn(y)).

Functions take the parameters as a dict of tensors under the names the
program's `state_dict()` uses, and work channels-first in float32. Each
hand-kernel site goes through `plain.KERNELS`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from portbench.reference import plain

DIMS = (32, 64, 128, 256)
DEPTH = 3
FEATURE = 16


def _stage_sizes(cfg):
    s = [i // p for i, p in zip(cfg["img_size"], cfg["patch_size"])]
    return [tuple(v // 2 ** i for v in s) for i in range(4)]


def _block_shapes(prefix, C, N):
    u = lambda fan: ("uniform", 1 / math.sqrt(fan))
    sh = {f"{prefix}.pos_embed": ((1, N, C), ("const", 0.0)),
          f"{prefix}.gamma": ((C,), ("const", 1.0)),
          f"{prefix}.norm.weight": ((C,), ("const", 1.0)),
          f"{prefix}.norm.bias": ((C,), ("const", 0.0))}
    g = f"{prefix}.epa_block"
    s = f"{g}.spatial_gating_unit"
    for name, shape, fan in ((f"{g}.proj_1", (C, C, 1, 1, 1), C),
                             (f"{s}.conv0", (C, 1, 5, 5, 5), 125),
                             (f"{s}.conv_spatial", (C, 1, 7, 7, 7), 343),
                             (f"{s}.conv1", (C, C, 1, 1, 1), C),
                             (f"{g}.proj_2", (C, C, 1, 1, 1), C),
                             (f"{prefix}.conv8.1", (C, C, 1, 1, 1), C)):
        sh[f"{name}.weight"] = (shape, u(fan))
        sh[f"{name}.bias"] = ((C,), u(fan))
    d = f"{s}.deform_conv"
    # the offsets' weights as the gates are driven: N(0, (10/sqrt(27 C))²)
    sh[f"{d}.conv_offset.weight"] = ((81, C, 3, 3, 3), ("normal", 10 / math.sqrt(27 * C)))
    sh[f"{d}.conv_offset.bias"] = ((81,), u(27 * C))
    sh[f"{d}.weight"] = ((C, C, 3, 3, 3), u(27 * C))
    sh[f"{d}.bias"] = ((C,), ("const", 0.0))
    for conv in ("conv1", "conv2"):
        sh[f"{prefix}.conv51.{conv}.conv.weight"] = ((C, C, 3, 3, 3), u(27 * C))
    for norm in ("norm1", "norm2"):
        n = f"{prefix}.conv51.{norm}"
        sh[f"{n}.weight"] = ((C,), ("const", 1.0))
        sh[f"{n}.bias"] = ((C,), ("const", 0.0))
        sh[f"{n}.running_mean"] = ((C,), ("const", 0.0))
        sh[f"{n}.running_var"] = ((C,), ("const", 1.0))
    return sh


def param_shapes(cfg) -> dict:
    """name → (shape, init) of every tensor of the model's state, init
    ("uniform", bound), ("normal", std) or ("const", value)."""
    u = lambda fan: ("uniform", 1 / math.sqrt(fan))
    sizes = _stage_sizes(cfg)
    ncls, fs = cfg["num_classes"], FEATURE
    pk = tuple(cfg["patch_size"])
    sh = {}
    enc = "d_lka_former_encoder"
    sh[f"{enc}.downsample_layers.0.0.conv.weight"] = ((DIMS[0], 1, *pk), u(math.prod(pk)))
    for i in range(4):
        if i:
            sh[f"{enc}.downsample_layers.{i}.0.conv.weight"] = (
                (DIMS[i], DIMS[i - 1], 2, 2, 2), u(8 * DIMS[i - 1]))
        sh[f"{enc}.downsample_layers.{i}.1.weight"] = ((DIMS[i],), ("const", 1.0))
        sh[f"{enc}.downsample_layers.{i}.1.bias"] = ((DIMS[i],), ("const", 0.0))
        for j in range(DEPTH):
            sh.update(_block_shapes(f"{enc}.stages.{i}.{j}", DIMS[i], math.prod(sizes[i])))
    sh["encoder1.conv1.conv.weight"] = ((fs, 1, 3, 3, 3), u(27))
    sh["encoder1.conv2.conv.weight"] = ((fs, fs, 3, 3, 3), u(27 * fs))
    sh["encoder1.conv3.conv.weight"] = ((fs, 1, 1, 1, 1), u(1))
    ups = (("decoder5", DIMS[3], fs * 8, 2), ("decoder4", fs * 8, fs * 4, 1),
           ("decoder3", fs * 4, fs * 2, 0))
    for name, cin, cout, stage in ups:
        sh[f"{name}.transp_conv.conv.weight"] = ((cin, cout, 2, 2, 2), u(8 * cin))
        for j in range(DEPTH):
            sh.update(_block_shapes(f"{name}.decoder_block.0.{j}", cout,
                                    math.prod(sizes[stage])))
    sh["decoder2.transp_conv.conv.weight"] = ((fs * 2, fs, *pk), u(math.prod(pk) * fs * 2))
    sh["decoder2.decoder_block.0.conv1.conv.weight"] = ((fs, fs, 3, 3, 3), u(27 * fs))
    sh["decoder2.decoder_block.0.conv2.conv.weight"] = ((fs, fs, 3, 3, 3), u(27 * fs))
    heads = [("out1", fs)] + ([("out2", fs * 2), ("out3", fs * 4)] if cfg["do_ds"] else [])
    for name, cin in heads:
        sh[f"{name}.conv.conv.weight"] = ((ncls, cin, 1, 1, 1), u(cin))
        sh[f"{name}.conv.conv.bias"] = ((ncls,), u(cin))
    return sh


def _lrelu(x):
    return F.leaky_relu(x, 0.01)


def _res_block(p, pre, x, norm):
    """MONAI's UnetResBlock, stride 1: conv-norm-lrelu-conv-norm, plus x
    (or its 1³ projection when the channels change), lrelu."""
    y = _lrelu(norm(F.conv3d(x, p[f"{pre}.conv1.conv.weight"], padding=1), f"{pre}.norm1"))
    y = norm(F.conv3d(y, p[f"{pre}.conv2.conv.weight"], padding=1), f"{pre}.norm2")
    if f"{pre}.conv3.conv.weight" in p:
        x = norm(F.conv3d(x, p[f"{pre}.conv3.conv.weight"]), f"{pre}.norm3")
    return _lrelu(y + x)


def _instance(x, _name):
    return F.instance_norm(x, eps=1e-5)


def _conv1(p, name, x):
    return F.conv3d(x, p[f"{name}.weight"], p[f"{name}.bias"])


def block(p, pre, x):
    B, C, D, H, W = x.shape
    t = x + p[f"{pre}.pos_embed"].transpose(1, 2).reshape(1, C, D, H, W)
    n = F.layer_norm(t.movedim(1, -1), (C,), p[f"{pre}.norm.weight"],
                     p[f"{pre}.norm.bias"], 1e-5).movedim(-1, 1)
    g = f"{pre}.epa_block"
    s = f"{g}.spatial_gating_unit"
    u = F.gelu(_conv1(p, f"{g}.proj_1", n))
    a = plain.KERNELS["dw_chain3d"](u, p[f"{s}.conv0.weight"], p[f"{s}.conv0.bias"],
                                   p[f"{s}.conv_spatial.weight"], p[f"{s}.conv_spatial.bias"])
    d = f"{s}.deform_conv"
    off = F.conv3d(a, p[f"{d}.conv_offset.weight"], p[f"{d}.conv_offset.bias"], padding=1)
    a = plain.KERNELS["deform_conv3d"](a, off, p[f"{d}.weight"], p[f"{d}.bias"])
    y = _conv1(p, f"{g}.proj_2", u * _conv1(p, f"{s}.conv1", a)) + n
    y = t + p[f"{pre}.gamma"].view(1, C, 1, 1, 1) * y

    def batch_norm(z, name):
        return F.batch_norm(z, p[f"{name}.running_mean"], p[f"{name}.running_var"],
                            p[f"{name}.weight"], p[f"{name}.bias"], False, 0.0, 1e-5)

    r = _res_block(p, f"{pre}.conv51", y, batch_norm)
    return y + _conv1(p, f"{pre}.conv8.1", r)


def _blocks(p, pre, x, remat):
    for j in range(DEPTH):
        if remat:
            x = torch.utils.checkpoint.checkpoint(block, p, f"{pre}.{j}", x, use_reentrant=False)
        else:
            x = block(p, f"{pre}.{j}", x)
    return x


def forward(p, cfg, x, remat=False):
    """x (B, 1, *img_size) → logits (B, C, *img_size), or with `do_ds` the
    list [full, 1/2, 1/4]. `remat` recomputes each block in the backward
    pass (the reference's memory, not its arithmetic)."""
    enc = "d_lka_former_encoder"
    pk = tuple(cfg["patch_size"])
    h, hidden = x, []
    for i in range(4):
        w = p[f"{enc}.downsample_layers.{i}.0.conv.weight"]
        h = F.conv3d(h, w, stride=pk if i == 0 else 2)
        h = F.group_norm(h, 1 if i == 0 else DIMS[i - 1],
                         p[f"{enc}.downsample_layers.{i}.1.weight"],
                         p[f"{enc}.downsample_layers.{i}.1.bias"], 1e-5)
        h = _blocks(p, f"{enc}.stages.{i}", h, remat)
        hidden.append(h)
    conv_block = _res_block(p, "encoder1", x, _instance)
    dec = hidden[3]
    outs = []
    for name, skip in (("decoder5", hidden[2]), ("decoder4", hidden[1]),
                       ("decoder3", hidden[0])):
        dec = F.conv_transpose3d(dec, p[f"{name}.transp_conv.conv.weight"], stride=2) + skip
        dec = _blocks(p, f"{name}.decoder_block.0", dec, remat)
        outs.append(dec)
    out = F.conv_transpose3d(dec, p["decoder2.transp_conv.conv.weight"], stride=pk) + conv_block
    out = _res_block(p, "decoder2.decoder_block.0", out, _instance)
    logits = F.conv3d(out, p["out1.conv.conv.weight"], p["out1.conv.conv.bias"])
    if not cfg["do_ds"]:
        return logits
    return [logits,
            F.conv3d(outs[2], p["out2.conv.conv.weight"], p["out2.conv.conv.bias"]),
            F.conv3d(outs[1], p["out3.conv.conv.weight"], p["out3.conv.conv.bias"])]


def loss(p, cfg, image, label, remat=False):
    """The deep-supervision Dice + CE loss; image (B, *S, 1), label (B, *S)."""
    return plain.deep_supervision_loss(
        forward(p, cfg, image.movedim(-1, 1), remat), label)


def is_param(name: str) -> bool:
    """Whether a state entry is a trained parameter (not a batch norm's
    running statistic)."""
    return not name.endswith(("running_mean", "running_var"))
