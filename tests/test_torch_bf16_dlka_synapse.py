"""`dlka_former_synapse` (16×32×32, full widths, 21 D-LKA blocks) on a
bfloat16 input, port against the JAX package, on the CPU.

The JAX model casts its weights to the input's type in its own convs, so
a bfloat16 input runs the stem conv, its GroupNorm and `encoder1` (three
convs, three instance norms) in bfloat16; the first D-LKA block promotes
at `tokens + pos_embed` and the decoder's last up-block at the bfloat16
skip. The port must do the same (tests/torch_bf16_parity.py): each of
those modules of the port on JAX's own input gives JAX's type and its
values to a rare one-ulp flip; along the whole forward the same types,
and float32 at every call of kernels 1 and 2; the logits float32 with
RMS(port − JAX bf16) under a tenth of RMS(JAX bf16 − f32) and the labels
equal on ≥ 0.9999 of the voxels.
"""

import numpy as np
import pytest
import torch

from deformablelka_tpu.models import dlka_former as jmodels
from deformablelka_tpu_torch.models import dlka_former as tmodels

import torch_bf16_parity as P
from test_torch_block_variants import jax_variables

torch.set_num_threads(1)
IMG = (16, 32, 32)
POINTS = {"encoder/stem_conv": "bfloat16", "encoder/stem_norm": "bfloat16",
          "encoder1": "bfloat16", "encoder/stage0_block0": "float32",
          "decoder2": "float32"}


@pytest.fixture(scope="module")
def run():
    x = np.random.RandomState(5).randn(1, *IMG, 1).astype(np.float32)
    jm = jmodels.dlka_former_synapse(num_classes=14, do_ds=False, img_size=IMG)
    tm = tmodels.dlka_former_synapse(14, do_ds=False, img_size=IMG, device="cpu")
    return P.Run(jm, jax_variables(jm, x, seed=5), x, tm)


def test_bf16_stretch_and_kernel_sites_follow_jax(run):
    P.check_run(run, POINTS, kernel_names=("deform_conv3d", "dw_chain3d"))


def test_float32_port_is_held_apart(run):
    """The float32 logits, what the port gave before it followed the
    input's type, fail the logits check: they are as far from JAX's bf16
    logits as JAX's own float32 ones (ratio 1)."""
    with pytest.raises(AssertionError):
        P.check_logits(run.ours32, run.ref16, run.ours32)
