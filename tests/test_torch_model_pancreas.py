"""The port's `dlka_net_pancreas` (stem patch (2, 2, 2)) against the JAX
package's at img_size (32, 32, 32), batch 2, full widths, on the CPU in
float32: max|port − JAX| ≤ 1e-4·max(1, max|JAX|) and the argmax equal at
every voxel; its published blocks take the fused chain 21 times.
"""

import torch

from test_torch_model_variants import assert_matches, carried_model, forward_with_counts

torch.set_num_threads(1)


def test_pancreas_model_matches_jax():
    x, _, ref, tm = carried_model("dlka_net_pancreas", (32, 32, 32), 2)
    got, max_offset, n_dw, n_chain = forward_with_counts(tm, x)
    assert (n_dw, n_chain) == (0, 21)
    assert max_offset > 1.0
    assert_matches(got, ref)
