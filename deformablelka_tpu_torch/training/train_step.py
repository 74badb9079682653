"""The training step: SGD with Nesterov momentum, weight decay, a global-norm
clip, and the deep-supervision loss.

Port of `make_sgd` and `make_train_step` in
`deformablelka_tpu/training/train_step.py`. The step reproduces
`optax.chain(clip_by_global_norm(12), add_decayed_weights(wd),
sgd(lr, momentum, nesterov=True))` step for step:

1. clip: with n = ‖g‖ over all parameters, g ← g · (12 / n) when n ≥ 12
   (optax's rule; `torch.nn.utils.clip_grad_norm_` divides by n + 1e-6,
   so it is not used);
2. g ← g + wd · p, then the Nesterov trace t ← g + μ · t (t starts at 0)
   and p ← p − lr · (g + μ · t): `torch.optim.SGD(momentum=μ,
   nesterov=True, weight_decay=wd)` does exactly this.

The trainers always clip at 12 with Nesterov on; momentum and weight
decay vary between them. A parameter that the loss does not reach gets a
zero gradient, as under `jax.grad`, so weight decay and momentum still
move it. The model's forward is already the training forward: the JAX
trainers build the model with `deterministic=True`, so dropout is the
identity and batch norm uses its running statistics
(`nn/transformer3d.py`).
"""

from __future__ import annotations

import torch

from deformablelka_tpu_torch.training.losses import deep_supervision_loss

CLIP_NORM = 12.0


def make_sgd(params, lr: float, momentum: float = 0.99,
             weight_decay: float = 3e-5) -> torch.optim.SGD:
    """The Synapse trainer's optimizer after the clip (`clip_grad_norm`):
    Nesterov momentum 0.99 and weight decay 3e-5 by default."""
    return torch.optim.SGD([p for p in params if p.requires_grad], lr=lr,
                           momentum=momentum, nesterov=True,
                           weight_decay=weight_decay)


@torch.no_grad()
def clip_grad_norm(params) -> torch.Tensor:
    """Clips the gradients in place to a global norm of 12, as optax does,
    and returns their norm before the clip (a device scalar: no host
    sync). A missing gradient becomes zeros."""
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, (CLIP_NORM / norm).clamp(max=1.0))
    return norm


def loss_of(model: torch.nn.Module, image, label):
    """The deep-supervision Dice + CE loss on one batch: image (B, *S, Cin),
    label (B, *S) int."""
    return deep_supervision_loss(model(image), label)


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.SGD):
    """Returns step(image, label) -> {"loss", "grad_norm"}, device scalars;
    the step updates the model's parameters in place."""
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(image, label):
        optimizer.zero_grad()
        loss = loss_of(model, image, label)
        loss.backward()
        grad_norm = clip_grad_norm(params)
        optimizer.step()
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    return step
