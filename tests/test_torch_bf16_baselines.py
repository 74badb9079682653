"""The Pancreas baselines on a bfloat16 input, port against the JAX
package, on the CPU, at 32³ (tests/torch_bf16_parity.py):

- VNet (4 filters): flax's `nn.Conv` promotes the input to its float32
  weights at the first conv, so everything after the input's rounding is
  float32 (`Promoting*` layers in the port);
- `Resnet34Seg` (full width): its encoder (37 of the repo's `Conv3d`, 37
  batch norms, 16 `BasicBlock3d`) runs in bfloat16; flax's
  `ConvTranspose` of the first up-block promotes;
- UNETR (hidden 48, 4 heads, MLP 96, feature size 4, 12 blocks): the
  patch embedding's `Linear` and `encoder1` run in bfloat16; the position
  embedding and the decoder's last concatenation promote.

For each: every module with a bfloat16 input or output, fed JAX's own
input, gives JAX's type and values to a rare one-ulp flip; the same
types along the whole forward; no kernel wrapper is called; the logits
float32 with RMS(port − JAX bf16) under a tenth of RMS(JAX bf16 − f32)
and the labels equal on ≥ 0.9999 of the voxels, where the port's float32
logits fail that check.
"""

import numpy as np
import pytest
import torch

from deformablelka_tpu.models import pancreas_baselines as jpb
from deformablelka_tpu_torch.models import pancreas_baselines as tpb

import torch_bf16_parity as P
from test_torch_maxvit import jax_variables

torch.set_num_threads(1)
PATCH = (32, 32, 32)
UNETR_SMALL = dict(img_size=PATCH, hidden=48, heads=4, mlp_dim=96, feature_size=4)
MODELS = {
    "vnet": (lambda: jpb.VNet(n_classes=2, n_filters=4),
             lambda: tpb.VNet(n_classes=2, n_filters=4),
             {"block_one/conv0": "float32", "block_one": "float32"}),
    "resnet34": (lambda: jpb.Resnet34Seg(n_classes=2), lambda: tpb.Resnet34Seg(n_classes=2),
                 {"resnet_encoder/conv1": "bfloat16", "resnet_encoder/layer4_2": "bfloat16",
                  "block_five_up/conv": "float32"}),
    "unetr": (lambda: jpb.UNETR(n_classes=2, **UNETR_SMALL),
              lambda: tpb.UNETR(n_classes=2, **UNETR_SMALL),
              {"patch_embed": "bfloat16", "encoder1": "bfloat16", "decoder2": "float32"}),
}


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(name):
        if name not in cache:
            make_jax, make_port, _ = MODELS[name]
            x = np.random.RandomState(1).randn(1, *PATCH, 1).astype(np.float32)
            jm = make_jax()
            cache[name] = P.Run(jm, jax_variables(jm, x), x, make_port())
        return cache[name]
    return get


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bf16_input_follows_jax(runs, name):
    P.check_run(runs(name), MODELS[name][2])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_float32_port_is_held_apart(runs, name):
    run = runs(name)
    with pytest.raises(AssertionError):
        P.check_logits(run.ours32, run.ref16, run.ours32)
