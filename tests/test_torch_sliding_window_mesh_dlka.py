"""The port's meshed sliding window with the D-LKA Former on 2 gloo ranks on
the CPU, against the JAX package's one-device engine.

`dlka_former_synapse` at img_size (16, 32, 32), JAX variables from seeded
numpy (`test_torch_block_variants.jax_variables`), a 16×40×32 volume: two
tiles along H, one per rank, each with the W flip in one batch of two.
Rank 0 loads the carried weights and `parallel.replicated` gives them to
rank 1, whose own init differs. Held at atol 1e-4, rtol 1e-4 and the
labels where the top two probabilities are 1e-3 apart, as
tests/test_torch_sliding_window.py holds the one-device port; both ranks
return the same probabilities and labels. The rank function is at
module level and JAX is imported inside the fixtures and the test only.
"""

import numpy as np
import pytest
import torch

from deformablelka_tpu_torch.inference.sliding_window import SlidingWindowInference
from deformablelka_tpu_torch.models.dlka_former import dlka_former_synapse
from deformablelka_tpu_torch.parallel import make_mesh, replicated
from deformablelka_tpu_torch.parallel.launch import run_ranks

torch.set_num_threads(1)
IMG = (16, 32, 32)
VOL = np.random.RandomState(3).randn(16, 40, 32, 1).astype(np.float32)
ENGINE = dict(patch_size=IMG, num_classes=14, do_mirroring=True, mirror_axes=(2,),
              tta_batch=2)


def _ranks(rank, world, state):
    mesh = make_mesh(("data",), device_type="cpu")
    tm = dlka_former_synapse(num_classes=14, do_ds=False, img_size=IMG, device="cpu",
                             seed=rank)
    if rank == 0:
        tm.load_state_dict(state, strict=True)
    replicated(tm)
    sw = SlidingWindowInference(tm, mesh=mesh, **ENGINE)
    return {"tiles": len(sw.local_origins(sw.origins(VOL.shape[:3]))),
            "probs": sw.predict(VOL), "seg": sw.predict_segmentation(VOL)}


@pytest.fixture(scope="module")
def carried():
    """The JAX model, its variables and the port's state_dict of them."""
    import jax.numpy as jnp

    from deformablelka_tpu.models.dlka_former import dlka_former_synapse as jax_synapse
    from deformablelka_tpu_torch.convert.jax_params import state_dict_from_jax
    from test_torch_block_variants import jax_variables

    jm = jax_synapse(num_classes=14, do_ds=False, img_size=IMG)
    v = jax_variables(jm, jnp.zeros((1, *IMG, 1)), seed=6)
    tm = dlka_former_synapse(num_classes=14, do_ds=False, img_size=IMG, device="cpu")
    return jm, v, state_dict_from_jax(v, tm)


def test_dlka_former_on_two_ranks_matches_jax(tmp_path, carried):
    from deformablelka_tpu.inference.sliding_window import (
        SlidingWindowInference as JaxSlidingWindow)

    jm, v, state = carried
    results = run_ranks(_ranks, 2, tmp_path, state)
    assert [r["tiles"] for r in results] == [1, 1]
    ref = JaxSlidingWindow(jm.apply, loop_mode="host", **ENGINE).predict(v, VOL)
    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-3
    assert clear.mean() > 0.9
    for r in results:
        assert r["probs"].shape == ref.shape == (16, 40, 32, 14)
        np.testing.assert_allclose(r["probs"], ref, atol=1e-4, rtol=1e-4)
        np.testing.assert_array_equal(r["seg"][clear], np.argmax(ref, -1)[clear])
        np.testing.assert_array_equal(r["probs"], results[0]["probs"])
        np.testing.assert_array_equal(r["seg"], results[0]["seg"])
