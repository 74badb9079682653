"""Carry the JAX package's weights into the port.

`state_dict_from_jax(variables, module)` turns JAX variables, given as
nested dicts of numpy arrays (`{"params": ..., "batch_stats": ...}`), into
a state_dict for `module`, the port's counterpart of the JAX module they
came from: a whole model (`DLKAFormer`, `MaxViTDeformableLKAFormer`), or
any submodule down to one conv. On the modules of this package it is the
inverse of `deformablelka_tpu.convert.torch_loader.convert_dlka_former`,
`convert_maxvit_dlka` and the converters of the 2D zoo (`convert_daeformer`,
`convert_daelka`, `convert_bidae`, `convert_swinunet`, `convert_mvitlka`,
`convert_datlka`, `convert_stvitlka`, `convert_semantic_stvit`,
`convert_segformer`, `convert_transunet`, `convert_hiformer`), of the
Pancreas baselines (`convert_vnet`, `convert_resnet34`, `convert_unetr`)
and of `convert_generic_unet`:

- module paths: the JAX names that differ from upstream's torch names are
  renamed. The 2D zoo's modules carry their own renames, `jax_renames`
  ((JAX name pattern, torch path) pairs, a pattern of two names such as
  `q_pool/norm` tried before those of one; a class attribute, or an
  instance one where the names depend on the configuration), for the
  names of their children; below a module that has them, a module without
  keeps its JAX names, so no global rename reaches a zoo model. Elsewhere
  the global renames hold (`encoder/stage0_block1` → `d_lka_former_encoder.stages.0.1`,
  `backbone/stage0_block1` → `backbone.backbone.stages.0.blocks.1`,
  `conv8` → `conv8.1`, `mlp_fc1` → `mlp.fc1`, …); of a name's renames and
  then the name itself, the first that names a submodule of `module` is
  taken. The 3D block variants' block-level names go into upstream's
  `epa_block` (`attn` → `epa_block`, `lka` → `epa_block.lka`,
  `fuse_norm`/`fuse_norm2` → `epa_block.norm`/`norm2`,
  `out_proj`/`out_proj2` and the leaf `temperature2` → `epa_block.*`),
  `se_fc1` → `se.fc1`, the 3D conv-gate's `conv` → `deform_conv`, and the
  2D-slice block's `conv0`, `conv_spatial`, `conv1` →
  `spatial_gating_unit.*`. A layer that MONAI wraps in a `Convolution` (a Sequential whose one child is
  `conv`) gets its `.conv`; MaxViT's `BNAct/bn` is the BNAct itself;
- leaves: a module's own renames first (`pos_embed_0` →
  `All2Cross.pos_embed.0`), then `scale` and flax's `kernel` → `weight`,
  `ls1` → `ls1.gamma`, `deform_conv_weight` → `deform_conv.weight`;
  batch stats `mean`/`var` → `running_mean`/`running_var`;
- layouts: conv kernels (k..., Cin/g, Cout) → (Cout, Cin/g, k...),
  transposed-conv kernels (kd, kh, kw, Cin, Cout) → (Cin, Cout, kd, kh,
  kw), and flipped in space where the JAX layer is flax's
  `nn.ConvTranspose` (a `StrideConvTranspose` here: the VNet family's
  and GenericUNet's up-convs, 2D or 3D), linear (Cin, Cout) → (Cout, Cin), and to a torch 1×1 conv (DAT's
  `proj_k`, `proj_v`) (Cout, Cin, 1, 1). A value whose shape is not its
  parameter's raises.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
import torch.nn as nn

from deformablelka_tpu_torch.nn.layers import ConvTranspose

_RENAMES = (
    (r"encoder", "d_lka_former_encoder"),
    (r"stem_conv", "downsample_layers.0.0"),
    (r"stem_norm", "downsample_layers.0.1"),
    (r"down(\d)_conv", r"downsample_layers.\1.0"),
    (r"down(\d)_norm", r"downsample_layers.\1.1"),
    (r"stage(\d)_block(\d+)", r"stages.\1.\2"),
    (r"stage(\d)_block(\d+)", r"stages.\1.blocks.\2"),
    (r"decoder_block(\d+)", r"decoder_block.0.\1"),
    (r"decoder_block", "decoder_block.0"),
    (r"conv8", "conv8.1"),
    (r"backbone", "backbone.backbone"),
    (r"final_norm", "norm"),
    (r"mlp_fc(\d)", r"mlp.fc\1"),
    (r"bn", ""),
    (r"attn", "epa_block"),
    (r"(lka|out_proj2?)", r"epa_block.\1"),
    (r"fuse_norm", "epa_block.norm"),
    (r"fuse_norm2", "epa_block.norm2"),
    (r"se_fc(\d)", r"se.fc\1"),
    (r"conv", "deform_conv"),
    (r"(conv0|conv_spatial|conv1)", r"spatial_gating_unit.\1"),
)
# leaf renames; where a leaf has several, the first whose owner has it
_LEAVES = {"params": {"scale": ("weight",), "ls1": ("ls1.gamma",),
                      "ls2": ("ls2.gamma",),
                      "deform_conv_weight": ("deform_conv.weight",),
                      "temperature2": ("epa_block.temperature2", "temperature2"),
                      "kernel": ("weight",)},
           "batch_stats": {"mean": ("running_mean",), "var": ("running_var",)}}


def _walk(tree, prefix=()) -> Iterator[Tuple[tuple, np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _descend(m: nn.Module, path: str):
    """The submodule at dotted `path` below m, or None."""
    for name in filter(None, path.split(".")):
        if name not in m._modules or m._modules[name] is None:
            return None
        m = m._modules[name]
    return m


def _children_table(m: nn.Module, zoo: bool) -> Tuple[tuple, bool]:
    """The renames for the JAX names of m's children: its class's own
    `jax_renames` if it has them, else none inside a module that has them
    (the zoo's families), else the global `_RENAMES`."""
    own = getattr(m, "jax_renames", None)
    if own is not None:
        return own, True
    return ((), True) if zoo else (_RENAMES, False)


def _candidates(table, p: str) -> list:
    return [re.sub(pat, repl, p) for pat, repl in table if re.fullmatch(pat, p)] + [p]


def _resolve(module: nn.Module, parts: tuple) -> Tuple[list, nn.Module, tuple]:
    """JAX module path → (torch attribute names, torch submodule, the
    renames for the JAX names of its children)."""
    names, m = [], module
    table, zoo = _children_table(module, False)
    i = 0
    while i < len(parts):
        # a rename of two JAX names ("q_pool/norm") before those of one
        pair = "/".join(parts[i:i + 2])
        cands = [(c, 2) for c in _candidates(table, pair)[:-1]] if i + 1 < len(parts) else []
        cands += [(c, 1) for c in _candidates(table, parts[i])]
        for cand, used in cands:
            sub = _descend(m, cand)
            if sub is not None:
                break
        else:
            raise KeyError(f"{'/'.join(parts)}: no submodule {[c for c, _ in cands]} under "
                           f"{'.'.join(names) or type(module).__name__}")
        i += used
        names += list(filter(None, cand.split(".")))
        m = sub
        if isinstance(m, nn.Sequential) and list(m._modules) == ["conv"]:
            m = m.conv
            names.append("conv")
        table, zoo = _children_table(m, zoo)
    return names, m, table


def _layout(owner: nn.Module, leaf: str, arr: np.ndarray) -> np.ndarray:
    if leaf == "weight" and getattr(owner, "jax_kernel_flipped", False):
        # a flax ConvTranspose: (k..., Cin, Cout), flipped in space
        nd = arr.ndim - 2
        w = arr.transpose(nd, nd + 1, *range(nd))
        return np.ascontiguousarray(w[(slice(None),) * 2 + (slice(None, None, -1),) * nd])
    if leaf == "weight" and arr.ndim == 5:
        if isinstance(owner, ConvTranspose):
            return arr.transpose(3, 4, 0, 1, 2)
        return arr.transpose(4, 3, 0, 1, 2)
    if leaf == "weight" and arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    if leaf == "weight" and arr.ndim == 2:
        target = getattr(owner, leaf)
        # a JAX Linear in place of a torch 1×1 conv
        return arr.T.reshape(target.shape) if target.ndim == 4 else arr.T
    return arr


def state_dict_from_jax(variables: Dict, module: nn.Module) -> Dict[str, torch.Tensor]:
    """JAX variables (nested numpy dicts) → a state_dict for `module`."""
    sd = {}
    for collection, leaves in _LEAVES.items():
        for parts, arr in _walk(variables.get(collection, {})):
            names, owner, table = _resolve(module, parts[:-1])
            for cand in _candidates(table, parts[-1])[:-1] + list(
                    leaves.get(parts[-1], (parts[-1],))):
                *sub, leaf = cand.split(".")
                o = _descend(owner, ".".join(sub))
                if o is not None and hasattr(o, leaf):
                    break
            else:
                raise KeyError(f"{'/'.join(parts)}: no parameter in "
                               f"{type(module).__name__}")
            value = torch.tensor(_layout(o, leaf, arr), dtype=torch.float32)
            target = getattr(o, leaf)
            if isinstance(target, torch.Tensor) and target.shape != value.shape:
                raise ValueError(f"{'/'.join(parts)}: shape {tuple(value.shape)} "
                                 f"for {tuple(target.shape)}")
            sd[".".join(names + sub + [leaf])] = value
    return sd
