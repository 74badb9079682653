"""The port's full `dlka_former_synapse` against the JAX package's, at
img_size (16, 32, 32) with the full widths (dims 32…256, 21 D-LKA
blocks), on the CPU in float32; and the weight round trip through the JAX
package's own converter.

Tolerance: atol 2e-4, rtol 1e-4 on logits of magnitude ~5 — 21 blocks of
f32 convolutions, summed in another order on each side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deformablelka_tpu.convert.torch_loader import convert_dlka_former
from deformablelka_tpu.models.dlka_former import dlka_former_synapse as jax_synapse
from deformablelka_tpu_torch.convert.jax_params import state_dict_from_jax
from deformablelka_tpu_torch.models.dlka_former import dlka_former_synapse
from deformablelka_tpu_torch.nn.blocks3d import DeformConvPack3d

from test_torch_modules import perturb

torch.set_num_threads(1)
IMG = (16, 32, 32)


@pytest.fixture(scope="module")
def carried():
    """JAX variables (perturbed), the JAX logits, the carried port model."""
    x = np.random.RandomState(0).randn(2, *IMG, 1).astype(np.float32)
    jm = jax_synapse(num_classes=14, do_ds=True, img_size=IMG)
    v = jax.tree_util.tree_map(np.asarray, dict(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(x))))
    v = perturb(v, seed=5, offset_scale=20.0)
    ref = [np.asarray(r) for r in jax.jit(jm.apply)(v, jnp.asarray(x))]
    tm = dlka_former_synapse(num_classes=14, do_ds=True, img_size=IMG,
                             device="cpu")
    tm.load_state_dict(state_dict_from_jax(v, tm), strict=True)
    return x, v, ref, tm


def test_full_model_matches_jax(carried):
    x, _, ref, tm = carried
    offsets = []
    hooks = [m.conv_offset.register_forward_hook(
        lambda _m, _i, out: offsets.append(out.abs().max().item()))
        for m in tm.modules() if isinstance(m, DeformConvPack3d)]
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for h in hooks:
        h.remove()
    assert len(offsets) == 21 and max(offsets) > 1.0
    assert [g.shape for g in got] == [r.shape for r in ref]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, atol=2e-4, rtol=1e-4)


def test_without_deep_supervision_is_the_first_head(carried):
    x, v, ref, _ = carried
    tm = dlka_former_synapse(num_classes=14, do_ds=False, img_size=IMG,
                             device="cpu")
    params = {k: val for k, val in v["params"].items()
              if k not in ("out2", "out3")}
    tm.load_state_dict(state_dict_from_jax(
        {"params": params, "batch_stats": v["batch_stats"]}, tm), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref[0], atol=2e-4, rtol=1e-4)


def test_state_dict_round_trips_through_the_jax_converter(carried):
    """port state_dict → convert_dlka_former → the JAX variables that went
    in, leaf for leaf."""
    _, v, _, tm = carried
    sd = {k: t.numpy() for k, t in tm.state_dict().items()}
    back = convert_dlka_former(sd)

    def flat(tree, prefix=""):
        out = {}
        for k, val in tree.items():
            if isinstance(val, dict):
                out.update(flat(val, f"{prefix}{k}/"))
            else:
                out[prefix + k] = np.asarray(val)
        return out

    for collection in ("params", "batch_stats"):
        want, got = flat(v[collection]), flat(back[collection])
        assert sorted(got) == sorted(want), collection
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_seeded_init_is_reproducible_and_follows_the_jax_init():
    """Same seed, same weights; the offset conv's weight is zero and its
    bias not (the JAX package's init, kept on purpose); gamma is 1e-6."""
    a = dlka_former_synapse(14, do_ds=False, img_size=IMG, seed=3, device="cpu")
    b = dlka_former_synapse(14, do_ds=False, img_size=IMG, seed=3, device="cpu")
    for (k, ta), tb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(ta, tb), k
    packs = [m for m in a.modules() if isinstance(m, DeformConvPack3d)]
    assert len(packs) == 21
    for m in packs:
        assert not m.conv_offset.weight.any()
        bound = 1 / np.sqrt(27 * m.weight.shape[1])
        assert 0 < m.conv_offset.bias.abs().max() <= bound
        assert 0 < m.weight.abs().max() <= bound and not m.bias.any()
    gammas = [p for n, p in a.named_parameters() if n.endswith("gamma")]
    assert len(gammas) == 21 and all(torch.all(g == 1e-6) for g in gammas)
