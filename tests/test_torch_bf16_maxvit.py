"""The 2D flagship, `MaxViTDeformableLKAFormer(num_classes=9)` at full
width (MaxViT-small, dims 96…768) and 64², on a bfloat16 input, port
against the JAX package, on the CPU (tests/torch_bf16_parity.py).

The stem, the first MBConv (batch norms, SiLU, the squeeze-excitation,
the average-pool shortcut) and the first block's window attention run in
bfloat16; its layer scale promotes. There the port rounds as JAX does:
SiLU and the gate's sigmoid as XLA expands the logistic, the pool as a
window sum, the attention scale in the input's type. The 12 calls of
kernel 4 in the decoder get float32. Layer scales 1 and offset nets that
push offsets past ±1 (`test_torch_maxvit.jax_variables`).
"""

import numpy as np
import pytest
import torch

from deformablelka_tpu.models.maxvit_dlka import MaxViTDeformableLKAFormer as JModel
from deformablelka_tpu_torch.models.maxvit_dlka import MaxViTDeformableLKAFormer

import torch_bf16_parity as P
from test_torch_maxvit import jax_variables

torch.set_num_threads(1)
IMG = 64
POINTS = {"backbone/stem": "bfloat16", "backbone/stage0_block0/conv": "bfloat16",
          "backbone/stage0_block0/attn_block/attn": "bfloat16",
          "backbone/stage0_block0/attn_block": "float32"}


@pytest.fixture(scope="module")
def run():
    x = np.random.RandomState(1).randn(1, IMG, IMG, 1).astype(np.float32)
    jm = JModel(num_classes=9, img_size=IMG)
    v = jax_variables(jm, x, seed=1, layer_scale=1.0)
    return P.Run(jm, v, x, MaxViTDeformableLKAFormer(9, IMG))


def test_bf16_stretch_and_kernel_sites_follow_jax(run):
    P.check_run(run, POINTS, kernel_names=("deform_dw_conv2d",))


def test_float32_port_is_held_apart(run):
    with pytest.raises(AssertionError):
        P.check_logits(run.ours32, run.ref16, run.ours32)
