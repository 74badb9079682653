"""The port's size-aware Synapse model, `dlka_former_synapse(trans_block=
"TransformerBlock_Deform_LKA_Spatial_sequential")`, against the JAX
package's at img_size (16, 32, 32), batch 2, full widths (dims 32…256,
21 blocks), on the CPU in float32; where its dilated depthwise convs run;
and `main_path.build` with that block.

JAX variables take their shapes from `jax.eval_shape` of the model's init
and their values from seeded numpy (`test_torch_block_variants.
jax_variables`); one `jax.jit(apply)` gives the reference. Tolerance:
max|port − JAX| ≤ 1e-4·max(1, max|JAX|) on the logits, and the argmax
equal at every voxel.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deformablelka_tpu.models import dlka_former as jmodels
from deformablelka_tpu.ops.pallas import dwconv3d_kernel as jdw
from deformablelka_tpu_torch import main_path
from deformablelka_tpu_torch.convert.jax_params import state_dict_from_jax
from deformablelka_tpu_torch.models import dlka_former as tmodels
from deformablelka_tpu_torch.nn.blocks3d import DeformConvPack3d, LKA3dDeformSizeAware
from deformablelka_tpu_torch.ops import dwconv3d, kernels, lka

from test_torch_block_variants import jax_variables

torch.set_num_threads(1)
SPATIAL_SEQ = "TransformerBlock_Deform_LKA_Spatial_sequential"
IMG = (16, 32, 32)


def carried_model(config: str, img, num_classes: int, trans_block=None, seed=0):
    """(input, JAX variables, JAX logits, carried port model) for the
    configuration `config` of both packages, without deep supervision,
    with `trans_block` where given and the configuration's block else."""
    x = np.random.RandomState(seed).randn(2, *img, 1).astype(np.float32)
    block = {"trans_block": trans_block} if trans_block else {}
    jm = getattr(jmodels, config)(num_classes=num_classes, do_ds=False,
                                  img_size=img, **block)
    v = jax_variables(jm, x, seed)
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    tm = getattr(tmodels, config)(num_classes, do_ds=False, img_size=img,
                                  device="cpu", **block)
    tm.load_state_dict(state_dict_from_jax(v, tm), strict=True)
    return x, v, ref, tm


def forward_with_counts(tm, x):
    """The port's logits, the largest |offset| of its deform convs, and
    how often its forward called `kernels.dwconv3d` and `kernels.dw_chain3d`."""
    offsets = []
    hooks = [m.conv_offset.register_forward_hook(
        lambda _m, _i, out: offsets.append(out.abs().max().item()))
        for m in tm.modules() if isinstance(m, DeformConvPack3d)]
    with mock.patch.object(kernels, "dwconv3d", wraps=dwconv3d.depthwise_conv3d_dilated) as dw, \
            mock.patch.object(kernels, "dw_chain3d", wraps=lka.dw_chain3d) as chain, \
            torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    for h in hooks:
        h.remove()
    return got, max(offsets), dw.call_count, chain.call_count


def assert_matches(got, ref):
    err = np.abs(got - ref).max()
    assert err <= 1e-4 * max(1.0, np.abs(ref).max()), err
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


@pytest.fixture(scope="module")
def spatial_seq():
    x, v, ref, tm = carried_model("dlka_former_synapse", IMG, 14, SPATIAL_SEQ)
    return x, v, ref, tm, forward_with_counts(tm, x)


def test_size_aware_model_matches_jax(spatial_seq):
    _, _, ref, _, (got, max_offset, _, _) = spatial_seq
    assert got.shape == ref.shape == (2, *IMG, 14)
    assert max_offset > 1.0
    assert_matches(got, ref)


def _jax_kernel_sites(jm, x, v, monkeypatch) -> int:
    """How many convs of one JAX forward its `conv3d` sends to
    `depthwise_conv3d_pallas` when that route is on and supported."""
    taken = []
    monkeypatch.setenv("DLKA_DWCONV_IMPL", "pallas")
    monkeypatch.setattr(jdw, "dwconv3d_supported", lambda *a: True)
    monkeypatch.setattr(jdw, "depthwise_conv3d_pallas",
                        lambda x, w, k, d: taken.append(w.shape) or x)
    jax.eval_shape(jm.apply, v, jnp.asarray(x))
    return len(taken)


def test_every_jax_kernel_site_reaches_a_kernel_of_the_port(spatial_seq, monkeypatch):
    """9 dilated depthwise convs per forward (3 blocks each of encoder
    stages 2 and 3 and decoder5) are `kernels.dwconv3d`; the JAX package
    would send them, and the 12 dilated halves of the dw5³ → dw7³-dil3
    pairs (fused into `kernels.dw_chain3d` in the port, as its fused LKA
    route does on the TPU), to its dilated depthwise kernel."""
    x, v, _, tm, (_, _, n_dw, n_chain) = spatial_seq
    assert (n_dw, n_chain) == (9, 12)
    jm = jmodels.dlka_former_synapse(14, do_ds=False, img_size=IMG,
                                     trans_block=SPATIAL_SEQ)
    assert _jax_kernel_sites(jm, x, v, monkeypatch) == n_dw + n_chain
    # in the JAX params: the size-aware gates' conv_spatial with K 5 or 3
    kernels_k = [w.shape for path, w in jax.tree_util.tree_leaves_with_path(v["params"])
                 if "conv_spatial" in jax.tree_util.keystr(path)
                 and w.shape[0] in (3, 5)]
    assert len(kernels_k) == 9
    gates = [m for m in tm.modules() if isinstance(m, LKA3dDeformSizeAware)]
    assert len(gates) == 21 and sum(not g.pair for g in gates) == 9


def test_main_path_builds_the_size_aware_configuration():
    model, sw = main_path.build(seed=0, device="cpu", trans_block=SPATIAL_SEQ)
    blocks = [m for m in model.modules() if type(m).__name__ == SPATIAL_SEQ]
    assert len(blocks) == 21
    assert all(torch.all(b.gamma == 1.0) for b in blocks)
    packs = [m for m in model.modules() if isinstance(m, DeformConvPack3d)]
    assert len(packs) == 21 and all(m.conv_offset.weight.any() for m in packs)
    assert sw.patch_size == main_path.PATCH and len(sw.origins(main_path.VOLUME)) == 8
    default, _ = main_path.build(seed=0, device="cpu")
    assert sum(type(m).__name__ == "TransformerBlock_3D_single_deform_LKA" for m in default.modules()) == 21
