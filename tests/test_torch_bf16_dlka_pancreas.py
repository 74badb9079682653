"""`dlka_net_pancreas` (32³, stem patch 2³, full widths) on a bfloat16
input, port against the JAX package, on the CPU: the checks of
tests/test_torch_bf16_dlka_synapse.py (tests/torch_bf16_parity.py) with
the Pancreas configuration, whose bfloat16 stretch is the same (the stem
conv and GroupNorm, `encoder1`) at other shapes.
"""

import numpy as np
import pytest
import torch

from deformablelka_tpu.models import dlka_former as jmodels
from deformablelka_tpu_torch.models import dlka_former as tmodels

import torch_bf16_parity as P
from test_torch_block_variants import jax_variables
from test_torch_bf16_dlka_synapse import POINTS

torch.set_num_threads(1)
IMG = (32, 32, 32)


@pytest.fixture(scope="module")
def run():
    x = np.random.RandomState(6).randn(1, *IMG, 1).astype(np.float32)
    jm = jmodels.dlka_net_pancreas(img_size=IMG)
    tm = tmodels.dlka_net_pancreas(img_size=IMG, device="cpu")
    return P.Run(jm, jax_variables(jm, x, seed=6), x, tm)


def test_bf16_stretch_and_kernel_sites_follow_jax(run):
    P.check_run(run, POINTS, kernel_names=("deform_conv3d", "dw_chain3d"))


def test_float32_port_is_held_apart(run):
    with pytest.raises(AssertionError):
        P.check_logits(run.ours32, run.ref16, run.ours32)
