"""The port's `dlka_former_synapse(trans_block=
"TransformerBlock_Deform_LKA_Channel_sequential")` against the JAX
package's at img_size (16, 32, 32), batch 2, full widths, on the CPU in
float32, as `test_torch_model_variants.py` holds the Spatial one: max|port
− JAX| ≤ 1e-4·max(1, max|JAX|) and the argmax equal at every voxel; its
forward calls `kernels.dwconv3d` 9 times and `kernels.dw_chain3d` 12.
"""

import torch

from test_torch_model_variants import IMG, assert_matches, carried_model, forward_with_counts

torch.set_num_threads(1)


def test_channel_sequential_model_matches_jax():
    x, _, ref, tm = carried_model("dlka_former_synapse", IMG, 14,
                                  "TransformerBlock_Deform_LKA_Channel_sequential")
    got, max_offset, n_dw, n_chain = forward_with_counts(tm, x)
    assert (n_dw, n_chain) == (9, 12)
    assert max_offset > 1.0
    assert_matches(got, ref)
