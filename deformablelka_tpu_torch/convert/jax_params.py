"""Carry the JAX package's weights into the port.

`state_dict_from_jax(variables, module)` turns JAX variables, given as
nested dicts of numpy arrays (`{"params": ..., "batch_stats": ...}`), into
a state_dict for `module`, the port's counterpart of the JAX module they
came from: a whole model (`DLKAFormer`, `MaxViTDeformableLKAFormer`), or
any submodule down to one conv. On the modules of this package it is the
inverse of `deformablelka_tpu.convert.torch_loader.convert_dlka_former`
and `convert_maxvit_dlka`:

- module paths: the JAX names that differ from upstream's torch names are
  renamed (`encoder/stage0_block1` → `d_lka_former_encoder.stages.0.1`,
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
- leaves: `scale` → `weight`, `ls1` → `ls1.gamma`, `deform_conv_weight`
  → `deform_conv.weight`; batch stats `mean`/`var` →
  `running_mean`/`running_var`;
- layouts: conv kernels (k..., Cin/g, Cout) → (Cout, Cin/g, k...),
  transposed-conv kernels (kd, kh, kw, Cin, Cout) → (Cin, Cout, kd, kh,
  kw), linear (Cin, Cout) → (Cout, Cin).
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
                      "temperature2": ("epa_block.temperature2", "temperature2")},
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


def _resolve(module: nn.Module, parts: tuple) -> Tuple[list, nn.Module]:
    """JAX module path → (torch attribute names, torch submodule)."""
    names, m = [], module
    for p in parts:
        cands = [re.sub(pat, repl, p) for pat, repl in _RENAMES
                 if re.fullmatch(pat, p)] + [p]
        for cand in cands:
            sub = _descend(m, cand)
            if sub is not None:
                break
        else:
            raise KeyError(f"{'/'.join(parts)}: no submodule {cands} under "
                           f"{'.'.join(names) or type(module).__name__}")
        names += list(filter(None, cand.split(".")))
        m = sub
        if isinstance(m, nn.Sequential) and list(m._modules) == ["conv"]:
            m = m.conv
            names.append("conv")
    return names, m


def _layout(owner: nn.Module, leaf: str, arr: np.ndarray) -> np.ndarray:
    if leaf == "weight" and arr.ndim == 5:
        if isinstance(owner, ConvTranspose):
            return arr.transpose(3, 4, 0, 1, 2)
        return arr.transpose(4, 3, 0, 1, 2)
    if leaf == "weight" and arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    if leaf == "weight" and arr.ndim == 2:
        return arr.T
    return arr


def state_dict_from_jax(variables: Dict, module: nn.Module) -> Dict[str, torch.Tensor]:
    """JAX variables (nested numpy dicts) → a state_dict for `module`."""
    sd = {}
    for collection, leaves in _LEAVES.items():
        for parts, arr in _walk(variables.get(collection, {})):
            for cand in leaves.get(parts[-1], (parts[-1],)):
                *sub, leaf = cand.split(".")
                try:
                    names, owner = _resolve(module, parts[:-1] + tuple(sub))
                except KeyError:
                    continue
                if hasattr(owner, leaf):
                    break
            else:
                raise KeyError(f"{'/'.join(parts)}: no parameter in "
                               f"{type(module).__name__}")
            sd[".".join(names + [leaf])] = torch.tensor(
                _layout(owner, leaf, arr), dtype=torch.float32)
    return sd
