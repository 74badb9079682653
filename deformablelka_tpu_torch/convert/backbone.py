"""Warm-start the 2D model's MaxViT encoder from a timm checkpoint.

The port's counterpart of `load_maxvit_backbone` in
`deformablelka_tpu/convert/torch_loader.py`: upstream's
`merit_lib/networks.py:239-252` loads maxvit_rmlp_small_rw_224_sw-*.pth
into the backbone before training. The port keeps upstream's (timm's)
names in `backbone.backbone`, so the load is a key mapping plus
`load_state_dict(strict=True)`:

- the file holds a state_dict, bare or under "state_dict",
  "model_weights" or "network_weights";
- its keys are timm's (`stem.conv1.weight`, …), or carry a `backbone.` or
  `backbone.backbone.` prefix (a whole model's state_dict);
- timm's classifier (`head.*`), which the 4-output encoder does not have,
  is dropped; every other key must match the encoder, batch-norm
  statistics included, as upstream's `load_state_dict` takes them.
"""

from __future__ import annotations

from pathlib import Path

import torch

_WRAPPERS = ("state_dict", "model_weights", "network_weights")


def encoder_state_dict(path: str | Path) -> dict:
    """The encoder's state_dict in the checkpoint at `path`, timm-keyed."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in _WRAPPERS:
        if isinstance(obj.get(key), dict):
            obj = obj[key]
            break
    sd = {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}
    for prefix in ("backbone.backbone.", "backbone."):
        if any(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
            break
    return {k: v for k, v in sd.items() if not k.startswith("head.")}


def load_maxvit_backbone(model, path: str | Path) -> None:
    """Load the encoder weights at `path` into `model.backbone.backbone`
    (a `MaxViTDeformableLKAFormer`), in place, on the model's device."""
    model.backbone.backbone.load_state_dict(encoder_state_dict(path), strict=True)
