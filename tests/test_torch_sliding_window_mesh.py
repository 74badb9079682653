"""The port's meshed sliding window (`SlidingWindowInference(mesh=)`) on
gloo ranks on the CPU, against the JAX package's engines.

- the `Tiny` model of tests/test_sliding_window.py (3³ conv, ReLU, 1³
  conv), its flax weights carried, on 2 and 4 ranks: against JAX's
  8-device mesh engine and its one-device engine at rtol 1e-5, atol 1e-6,
  as that test holds the two JAX engines; every rank returns the same
  probabilities and labels;
- the tile split: contiguous chunks of ceil(n / ranks), the weight-0 tiles
  of the JAX engine's padding skipped.

The D-LKA Former on 2 ranks is in test_torch_sliding_window_mesh_dlka.py.

The rank functions are at module level and JAX is imported inside the
tests only, so that a spawned rank imports neither.
"""

import numpy as np
import pytest
import torch

from deformablelka_tpu_torch.inference.sliding_window import SlidingWindowInference
from deformablelka_tpu_torch.ops.convs import conv3d
from deformablelka_tpu_torch.parallel import make_mesh
from deformablelka_tpu_torch.parallel.launch import run_ranks

torch.set_num_threads(1)
PATCH = (8, 8, 8)
TINY_VOL = np.random.RandomState(0).randn(12, 14, 10, 1).astype(np.float32)


def _tiny_weights():
    """The flax `Tiny`'s init (PRNGKey 0) as numpy, JAX layout."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    class Tiny(nn.Module):
        @nn.compact
        def __call__(self, x):
            h = nn.Conv(4, (3, 3, 3))(x)
            return nn.Conv(3, (1, 1, 1))(nn.relu(h))

    model = Tiny()
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, *PATCH, 1)))
    return model, v, jax.tree_util.tree_map(np.asarray, v["params"])


def _tiny_torch(p):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    w1, b1 = t(p["Conv_0"]["kernel"]).permute(4, 3, 0, 1, 2), t(p["Conv_0"]["bias"])
    w2, b2 = t(p["Conv_1"]["kernel"]).permute(4, 3, 0, 1, 2), t(p["Conv_1"]["bias"])
    return lambda x: conv3d(torch.relu(conv3d(x, w1, b1)), w2, b2)


def _ranks(rank, world, tiny_params):
    mesh = make_mesh(("data",), device_type="cpu")
    sw = SlidingWindowInference(_tiny_torch(tiny_params), PATCH, 3, step_size=0.5,
                                do_mirroring=True, mesh=mesh)
    out = {"tiny": sw.predict(TINY_VOL), "tiny_seg": sw.predict_segmentation(TINY_VOL),
           "tiles": len(sw.local_origins(sw.origins(TINY_VOL.shape[:3])))}
    return out


@pytest.fixture(scope="module")
def tiny():
    return _tiny_weights()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, tiny):
    return {n: run_ranks(_ranks, n, tmp_path_factory.mktemp(f"sw{n}"), tiny[2])
            for n in (2, 4)}


@pytest.mark.parametrize("world_size", [2, 4])
def test_tiny_matches_jax_mesh_and_one_device_engines(world_size, worlds, tiny):
    from deformablelka_tpu.inference.sliding_window import (
        SlidingWindowInference as JaxSlidingWindow)
    from deformablelka_tpu.parallel.mesh import make_mesh as jmake_mesh

    model, v, _ = tiny
    apply_fn = lambda variables, x: model.apply(variables, x)
    kw = dict(patch_size=PATCH, num_classes=3, step_size=0.5, do_mirroring=True)
    one = JaxSlidingWindow(apply_fn, **kw).predict(v, TINY_VOL)
    mesh = jmake_mesh(("data",))
    assert mesh.shape["data"] == 8
    eight = JaxSlidingWindow(apply_fn, mesh=mesh, **kw).predict(v, TINY_VOL)
    results = worlds[world_size]
    for r in results:
        np.testing.assert_allclose(r["tiny"], eight, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["tiny"], one, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(r["tiny"], results[0]["tiny"])
        np.testing.assert_array_equal(r["tiny_seg"], results[0]["tiny_seg"])
    np.testing.assert_array_equal(results[0]["tiny_seg"], np.argmax(results[0]["tiny"], -1))


@pytest.mark.parametrize("world_size", [2, 4])
def test_tiles_split_in_contiguous_chunks(world_size, worlds):
    sw = SlidingWindowInference(lambda x: x, PATCH, 3, device="cpu")
    n = len(sw.origins(TINY_VOL.shape[:3]))
    per = -(-n // world_size)
    assert [r["tiles"] for r in worlds[world_size]] == [
        len(range(n)[i * per:(i + 1) * per]) for i in range(world_size)]
    assert sum(r["tiles"] for r in worlds[world_size]) == n
