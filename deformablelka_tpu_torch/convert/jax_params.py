"""Carry the JAX package's weights into the port.

`state_dict_from_jax(variables, module)` turns JAX variables, given as
nested dicts of numpy arrays (`{"params": ..., "batch_stats": ...}`), into
a state_dict for `module`, the port's counterpart of the JAX module they
came from: the whole `DLKAFormer`, or any submodule down to one `Conv3d`.
On the modules of this package it is the inverse of
`deformablelka_tpu.convert.torch_loader.convert_dlka_former`:

- module paths: the JAX names that differ from upstream's torch names are
  renamed (`encoder/stage0_block1` → `d_lka_former_encoder.stages.0.1`,
  `conv8` → `conv8.1`, …), and a layer that MONAI wraps in a
  `Convolution` (a Sequential whose one child is `conv`) gets its `.conv`;
- leaves: `scale` → `weight`; batch stats `mean`/`var` →
  `running_mean`/`running_var`;
- layouts: conv kernels (kd, kh, kw, Cin/g, Cout) → (Cout, Cin/g, kd, kh,
  kw), transposed-conv kernels (kd, kh, kw, Cin, Cout) → (Cin, Cout, kd,
  kh, kw), linear (Cin, Cout) → (Cout, Cin).
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
    (r"decoder_block(\d+)", r"decoder_block.0.\1"),
    (r"decoder_block", "decoder_block.0"),
    (r"conv8", "conv8.1"),
)
_LEAVES = {"params": {"scale": "weight"},
           "batch_stats": {"mean": "running_mean", "var": "running_var"}}


def _walk(tree, prefix=()) -> Iterator[Tuple[tuple, np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _resolve(module: nn.Module, parts: tuple) -> Tuple[list, nn.Module]:
    """JAX module path → (torch attribute names, torch submodule)."""
    names, m = [], module
    for p in parts:
        for pattern, repl in _RENAMES:
            if re.fullmatch(pattern, p):
                p = re.sub(pattern, repl, p)
                break
        for name in p.split("."):
            m = m.get_submodule(name)
            names.append(name)
        if isinstance(m, nn.Sequential) and list(m._modules) == ["conv"]:
            m = m.conv
            names.append("conv")
    return names, m


def _layout(owner: nn.Module, leaf: str, arr: np.ndarray) -> np.ndarray:
    if leaf == "weight" and arr.ndim == 5:
        if isinstance(owner, ConvTranspose):
            return arr.transpose(3, 4, 0, 1, 2)
        return arr.transpose(4, 3, 0, 1, 2)
    if leaf == "weight" and arr.ndim == 2:
        return arr.T
    return arr


def state_dict_from_jax(variables: Dict, module: nn.Module) -> Dict[str, torch.Tensor]:
    """JAX variables (nested numpy dicts) → a state_dict for `module`."""
    sd = {}
    for collection, leaves in _LEAVES.items():
        for parts, arr in _walk(variables.get(collection, {})):
            names, owner = _resolve(module, parts[:-1])
            leaf = leaves.get(parts[-1], parts[-1])
            sd[".".join(names + [leaf])] = torch.tensor(
                _layout(owner, leaf, arr), dtype=torch.float32)
    return sd
