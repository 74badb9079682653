"""The losses of the 3D and 2D training steps, channels-last.

Port of `deformablelka_tpu/training/losses.py`: nnUNet's soft Dice (batch
dice, background dropped, smooth 1e-5) plus cross-entropy, the
deep-supervision sum with weights 1/2^i normalised over order-0
downsampled label maps, the poly learning-rate schedule, the 2D trainer's
0.4·CE + 0.6·Dice (`dice_ce_2d_loss`), and nnUNet's other losses: the
squared soft Dice, the generalised Dice and the top-k cross-entropy.
Logits are (B, *S, C), labels (B, *S) integers; every loss is computed
in float32.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


def softmax_helper(logits):
    return torch.softmax(logits.float(), dim=-1)


def one_hot(labels, num_classes):
    """labels (...,) int → (..., num_classes) float32."""
    return F.one_hot(labels.long(), num_classes).float()


class SoftDiceLoss:
    """nnUNet-style soft dice. logits (B, *S, C), labels (B, *S) int."""

    def __init__(self, batch_dice=True, do_bg=False, smooth=1e-5):
        self.batch_dice = batch_dice
        self.do_bg = do_bg
        self.smooth = smooth

    def __call__(self, logits, labels, loss_mask=None):
        C = logits.shape[-1]
        probs = softmax_helper(logits)
        y = one_hot(labels, C)
        axes = tuple(range(1, logits.ndim - 1))  # spatial
        if self.batch_dice:
            axes = (0,) + axes
        if loss_mask is not None:
            m = loss_mask[..., None]
            probs = probs * m
            y = y * m
        tp = (probs * y).sum(axes)
        fp = (probs * (1 - y)).sum(axes)
        fn = ((1 - probs) * y).sum(axes)
        dc = (2 * tp + self.smooth) / (2 * tp + fp + fn + self.smooth)
        if not self.do_bg:
            dc = dc[..., 1:]
        return -dc.mean()


def soft_dice_squared(logits, labels, smooth=1e-5, do_bg=False,
                      batch_dice=True):
    """SoftDiceLossSquared (dice_loss.py:245): the denominator sums p² + y²."""
    C = logits.shape[-1]
    probs = softmax_helper(logits)
    y = one_hot(labels, C)
    axes = tuple(range(1, logits.ndim - 1))
    if batch_dice:
        axes = (0,) + axes
    inter = (probs * y).sum(axes)
    denom = (probs * probs + y * y).sum(axes)
    dc = (2 * inter + smooth) / (denom + smooth)
    if not do_bg:
        dc = dc[..., 1:]
    return -dc.mean()


def generalized_dice_loss(logits, labels, smooth=1e-5, do_bg=True,
                          square_volumes=True):
    """GDL (dice_loss.py:25): class weights 1/volume² (1/volume unless
    `square_volumes`), volumes over the whole batch."""
    C = logits.shape[-1]
    probs = softmax_helper(logits)
    y = one_hot(labels, C)
    axes = (0,) + tuple(range(1, logits.ndim - 1))
    if not do_bg:
        probs, y = probs[..., 1:], y[..., 1:]
    vol = y.sum(axes)
    w = 1.0 / (vol * vol if square_volumes else vol).clamp(min=1e-6)
    tp = (probs * y).sum(axes) * w
    fp = (probs * (1 - y)).sum(axes) * w
    fn = ((1 - probs) * y).sum(axes) * w
    dc = (2 * tp.sum() + smooth) / (2 * tp.sum() + fp.sum() + fn.sum() + smooth)
    return -dc


def topk_cross_entropy(logits, labels, k_percent=10.0):
    """TopK loss (TopK_loss.py): the mean cross-entropy of the hardest
    k % of the voxels (at least one)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    flat = ll.reshape(-1)
    k = max(1, int(flat.shape[0] * k_percent / 100))
    return torch.topk(flat, k).values.mean()


def cross_entropy(logits, labels, loss_mask=None):
    """Mean CE over voxels; labels int (B, *S)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if loss_mask is not None:
        return -(ll * loss_mask).sum() / loss_mask.sum().clamp(min=1)
    return -ll.mean()


def dc_and_ce_loss(logits, labels, weight_ce=1.0, weight_dice=1.0,
                   batch_dice=True, smooth=1e-5, loss_mask=None):
    dice = SoftDiceLoss(batch_dice=batch_dice, smooth=smooth)(
        logits, labels, loss_mask)
    ce = cross_entropy(logits, labels, loss_mask)
    return weight_ce * ce + weight_dice * dice


def dice_ce_2d_loss(logits, labels, ce_weight=0.4, dice_weight=0.6):
    """The 2D trainer loss (trainer_MaxViT_deform_LKA.py:137-139):
    0.4·CE + 0.6·(1 - mean one-hot soft dice). Per-batch dice with smooth
    1e-5 including background (2D/utils.py:11-47): each class summed over
    the whole batch, squared terms in the denominator."""
    C = logits.shape[-1]
    probs = softmax_helper(logits)
    y = one_hot(labels, C)
    axes = tuple(range(0, logits.ndim - 1))
    inter = (probs * y).sum(axes)
    psum = (probs * probs).sum(axes)
    ysum = (y * y).sum(axes)
    smooth = 1e-5
    dice_loss = 1.0 - ((2 * inter + smooth) / (psum + ysum + smooth)).mean()
    return ce_weight * cross_entropy(logits, labels) + dice_weight * dice_loss


def deep_supervision_weights(n_outputs: int) -> np.ndarray:
    """1/2^i normalised (d_lka_former_trainer_synapse.py:92-108)."""
    w = np.array([1 / (2 ** i) for i in range(n_outputs)])
    return w / w.sum()


def downsample_labels(labels, factor):
    """Order-0 (strided) downsample of an int label map (B, *S): the
    deep-supervision targets."""
    sl = (slice(None),) + tuple(slice(None, None, f) for f in factor)
    return labels[sl]


def deep_supervision_loss(outputs: Sequence, labels, loss_fn=dc_and_ce_loss):
    """Weighted sum of per-scale losses; the target of scale i is the
    order-0 downsampled label map that matches outputs[i]."""
    w = deep_supervision_weights(len(outputs))
    total = 0.0
    full = labels.shape[1:]
    for i, out in enumerate(outputs):
        factor = tuple(f // s for f, s in zip(full, out.shape[1:-1]))
        total = total + float(w[i]) * loss_fn(out, downsample_labels(labels, factor))
    return total


def poly_lr(epoch, max_epochs, initial_lr, exponent=0.9):
    return initial_lr * (1 - epoch / max_epochs) ** exponent
