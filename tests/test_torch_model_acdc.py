"""The port's `dlka_former_acdc` (stem patch (1, 4, 4), the published
block name mapped onto the anisotropic `_acdc` variant) against the JAX
package's at img_size (8, 64, 64), batch 2, full widths, on the CPU in
float32: max|port − JAX| ≤ 1e-4·max(1, max|JAX|) and the argmax equal at
every voxel. None of its convs is a site of the dilated depthwise kernel.
"""

import torch

from test_torch_model_variants import assert_matches, carried_model, forward_with_counts

torch.set_num_threads(1)


def test_acdc_model_matches_jax():
    x, _, ref, tm = carried_model("dlka_former_acdc", (8, 64, 64), 4)
    got, max_offset, n_dw, n_chain = forward_with_counts(tm, x)
    assert (n_dw, n_chain) == (0, 0)
    assert sum(type(m).__name__ == "TransformerBlock_3D_single_deform_LKA_acdc"
               for m in tm.modules()) == 21
    assert max_offset > 1.0
    assert_matches(got, ref)
