"""Normalisation layers over channels-last tensors.

Port of `deformablelka_tpu/nn/norms.py`. Statistics are taken in float32
in the same order of operations as the JAX package. Parameters carry
torch's names (`weight`, `bias`, and the buffers `running_mean`,
`running_var` of batch norm), which the weight converter maps onto the
JAX names (`scale`, `bias`, `mean`, `var`).
"""

from __future__ import annotations

import torch
import torch.nn as nn


class _Affine(nn.Module):
    def __init__(self, num_channels: int, affine: bool = True):
        super().__init__()
        if affine:
            self.weight = nn.Parameter(torch.ones(num_channels))
            self.bias = nn.Parameter(torch.zeros(num_channels))
        else:
            self.weight = self.bias = None

    def reset_parameters(self, generator=None):
        if self.weight is not None:
            with torch.no_grad():
                self.weight.fill_(1.0)
                self.bias.zero_()

    def _affine(self, y):
        if self.weight is not None:
            y = y * self.weight + self.bias
        return y


class LayerNorm(_Affine):
    """LayerNorm over the last axis (eps 1e-5, as torch)."""

    def __init__(self, num_channels: int, eps: float = 1e-5):
        super().__init__(num_channels)
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        y = (xf - mean) / torch.sqrt(var + self.eps)
        return self._affine(y).to(x.dtype)


class GroupNorm(_Affine):
    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__(num_channels)
        self.num_groups, self.eps = num_groups, eps

    def forward(self, x):
        B, C = x.shape[0], x.shape[-1]
        G = self.num_groups
        xf = x.float()
        xg = xf.reshape(B, -1, G, C // G)
        mean = xg.mean((1, 3), keepdim=True)
        var = (xg - mean).square().mean((1, 3), keepdim=True)
        y = ((xg - mean) / torch.sqrt(var + self.eps)).reshape(xf.shape)
        return self._affine(y).to(x.dtype)


class InstanceNorm(_Affine):
    """Per sample, per channel over the spatial axes."""

    def __init__(self, num_channels: int, eps: float = 1e-5,
                 affine: bool = True):
        super().__init__(num_channels, affine)
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        axes = tuple(range(1, xf.ndim - 1))
        mean = xf.mean(axes, keepdim=True)
        var = (xf - mean).square().mean(axes, keepdim=True)
        y = (xf - mean) / torch.sqrt(var + self.eps)
        return self._affine(y).to(x.dtype)


class BatchNorm(_Affine):
    """Batch norm in eval mode: the running statistics normalise. This is
    also its training mode in the port: the JAX trainers run the model
    with `deterministic=True`, so batch statistics are never used."""

    def __init__(self, num_channels: int, eps: float = 1e-5):
        super().__init__(num_channels)
        self.eps = eps
        self.register_buffer("running_mean", torch.zeros(num_channels))
        self.register_buffer("running_var", torch.ones(num_channels))

    def reset_parameters(self, generator=None):
        super().reset_parameters(generator)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x):
        y = (x.float() - self.running_mean) / torch.sqrt(
            self.running_var + self.eps)
        return self._affine(y).to(x.dtype)
