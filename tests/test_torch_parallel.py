"""The port's `parallel/` against the JAX package's, on gloo ranks on the CPU.

Each world of ranks is started once per module (`parallel.launch.run_ranks`,
spawned processes, a `file://` store under the test's tmp directory); the
rank functions below run everything a world checks and send back what the
tests compare. They live at module level and this module imports JAX only
inside the tests, so that a spawned rank imports neither.

- the mesh: coordinates and lines of a 2 × 2 ("data", "space") mesh,
  `shard_batch` and its refusal of a batch that does not divide,
  `replicated`;
- `halo_exchange` at 2 and 4 ranks: the neighbours' slabs and zero ends,
  bitwise, the `ValueError`, and its backward (each halo's gradient added
  into the owner's boundary slab), bitwise against numpy;
- `spatial_shard_map_conv3d`, each case of tests/test_spatial_sharding.py,
  on 4 ranks against JAX's on a 4-device mesh and against the unsharded
  conv, atol 1e-5 (weights scaled to outputs of order 1); the gradient
  through the halos (x, w, b) against `jax.grad` through JAX's
  `shard_map`, atol 1e-5 · max(1, max|JAX|) per tensor (w's and b's
  gradients sum 2560 voxels: entries of order 50);
- the data × space step of `__graft_entry__._dryrun_dp_sp` on a 2 × 2
  mesh: the loss and the updated parameters against JAX's, rtol 1e-5.
"""

import numpy as np
import pytest
import torch

from deformablelka_tpu_torch.ops.convs import conv3d
from deformablelka_tpu_torch.parallel import batch_sharding, make_mesh, replicated, shard_batch
from deformablelka_tpu_torch.parallel.launch import run_ranks
from deformablelka_tpu_torch.parallel.spatial import (dp_sp_step, halo_exchange,
                                                      spatial_conv3d, spatial_shard_map_conv3d)

torch.set_num_threads(1)
# (k, dilation, depthwise): tests/test_spatial_sharding.py's cases
CONV_CASES = [(3, 1, False), (5, 1, False), (3, 2, False), (3, 1, True)]
C = 6


def _conv_inputs(k, groups_all):
    rs = np.random.RandomState(0)
    groups = C if groups_all else 1
    x = rs.randn(2, 16, 8, 10, C).astype(np.float32)
    # JAX layout; scaled to outputs of order 1, where atol 1e-5 is float32's
    w = (rs.randn(k, k, k, C // groups, C) / np.sqrt(k ** 3 * C // groups)).astype(np.float32)
    b = rs.randn(C).astype(np.float32)
    g = rs.randn(2, 16, 8, 10, C).astype(np.float32)          # a cotangent
    return x, w, b, g, groups


def _torch_w(w):
    return torch.from_numpy(w).permute(4, 3, 0, 1, 2).contiguous()


def _dp_sp_inputs():
    """`_dryrun_dp_sp(4)`'s inputs: 2 × 2 mesh, B 2, D 16, H = W = 8, C 4,
    3 classes, drawn in its order."""
    rng = np.random.RandomState(0)
    params = {"w1": (rng.randn(3, 3, 3, 1, 4) * 0.3).astype(np.float32),
              "w2": (rng.randn(3, 3, 3, 4, 4) * 0.2).astype(np.float32),
              "w3": (rng.randn(1, 1, 1, 4, 3) * 0.2).astype(np.float32)}
    x = rng.randn(2, 16, 8, 8, 1).astype(np.float32)
    y = rng.randint(0, 3, (2, 16, 8, 8)).astype(np.int32)
    return params, x, y


def _halo_slab(rank, L):
    """Rank `rank`'s seeded slab (1, L, 2, 3, 2)."""
    return np.random.RandomState(100 + rank).randn(1, L, 2, 3, 2).astype(np.float32)


def _halos(rank, world, mesh, L, radii):
    out = {}
    x_np = _halo_slab(rank, L)
    for r in radii:
        x = torch.from_numpy(x_np).requires_grad_()
        y = halo_exchange(x, r, mesh.group("space"))
        g = torch.from_numpy(np.random.RandomState(200 + rank).randn(*y.shape).astype(np.float32))
        y.backward(g)
        out[r] = (y.detach().numpy(), g.numpy(), x.grad.numpy())
    try:
        halo_exchange(torch.from_numpy(x_np), L + 1, mesh.group("space"))
        out["raises"] = False
    except ValueError:
        out["raises"] = True
    return out


def _world2(rank, world):
    mesh = make_mesh(("space",), device_type="cpu")
    return {"halo": _halos(rank, world, mesh, 3, (1, 2, 3))}


def _world4(rank, world, conv_inputs, dp_sp):
    out = {}
    mesh2 = make_mesh(("data", "space"), shape=(2, 2), device_type="cpu")
    out["coords"] = (mesh2.coordinate("data"), mesh2.coordinate("space"),
                     mesh2.ranks("data"), mesh2.ranks("space"))
    out["shard"] = shard_batch(mesh2, {"a": np.arange(8), "b": [torch.arange(4)]})
    try:
        batch_sharding(mesh2, 3)
        out["odd_batch_raises"] = False
    except ValueError:
        out["odd_batch_raises"] = True
    torch.manual_seed(rank)
    m = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.BatchNorm1d(2))
    m[1].running_mean.normal_()
    replicated(m)
    out["replicated"] = {k: v.clone() for k, v in m.state_dict().items()}

    mesh = make_mesh(("space",), device_type="cpu")
    out["halo"] = _halos(rank, world, mesh, 2, (1, 2))
    convs = []
    i, per = mesh.coordinate("space"), 16 // 4
    for (k, dil, _), (x, w, b, g, groups) in zip(CONV_CASES, conv_inputs):
        f = spatial_shard_map_conv3d(mesh, "space", dilation=dil, groups=groups)
        wt, bt = _torch_w(w), torch.from_numpy(b)
        y = f(torch.from_numpy(x), wt, bt)
        xl = torch.from_numpy(x[:, i * per:(i + 1) * per]).requires_grad_()
        wt.requires_grad_()
        bt.requires_grad_()
        yl = spatial_conv3d(xl, wt, mesh.group("space"), bias=bt, dilation=dil, groups=groups)
        (yl * torch.from_numpy(g[:, i * per:(i + 1) * per])).sum().backward()
        convs.append((y.numpy(), xl.grad.numpy(), wt.grad.numpy(), bt.grad.numpy()))
    out["convs"] = convs

    params, x, y = dp_sp
    d, s = mesh2.coordinate("data"), mesh2.coordinate("space")
    tp = {k: _torch_w(v) for k, v in params.items()}
    new, loss = dp_sp_step(tp, torch.from_numpy(x[d:d + 1, s * 8:(s + 1) * 8]),
                           torch.from_numpy(y[d:d + 1, s * 8:(s + 1) * 8]), mesh2)
    out["dp_sp"] = ({k: v.numpy() for k, v in new.items()}, float(loss))
    return out


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return run_ranks(_world2, 2, tmp_path_factory.mktemp("world2"))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    conv_inputs = [_conv_inputs(k, dw) for k, _, dw in CONV_CASES]
    return run_ranks(_world4, 4, tmp_path_factory.mktemp("world4"), conv_inputs,
                     _dp_sp_inputs())


def test_mesh_coordinates_shards_and_replicas(world4):
    assert [r["coords"] for r in world4] == [
        (0, 0, [0, 2], [0, 1]), (0, 1, [1, 3], [0, 1]),
        (1, 0, [0, 2], [2, 3]), (1, 1, [1, 3], [2, 3])]
    for rank, r in enumerate(world4):
        d = rank // 2
        np.testing.assert_array_equal(r["shard"]["a"], np.arange(8)[4 * d:4 * d + 4])
        assert torch.equal(r["shard"]["b"][0], torch.arange(4)[2 * d:2 * d + 2])
        assert r["odd_batch_raises"]
        for k, v in r["replicated"].items():
            assert torch.equal(v, world4[0]["replicated"][k]), k


def _expected_halo(world, L, r):
    """The haloed slabs and the slabs' gradients that the exchange must give,
    from every rank's slab and cotangent."""
    slabs = [_halo_slab(i, L) for i in range(world)]
    zero = np.zeros_like(slabs[0][:, :r])
    ys, gxs = [], []
    for i in range(world):
        prev = slabs[i - 1][:, L - r:] if i > 0 else zero
        nxt = slabs[i + 1][:, :r] if i < world - 1 else zero
        ys.append(np.concatenate([prev, slabs[i], nxt], 1))
    gs = [np.random.RandomState(200 + i).randn(*ys[i].shape).astype(np.float32)
          for i in range(world)]
    for i in range(world):
        gx = gs[i][:, r:r + L].copy()
        if i > 0:   # my bottom slab was the previous rank's upper halo
            gx[:, :r] += gs[i - 1][:, r + L:]
        if i < world - 1:
            gx[:, L - r:] += gs[i + 1][:, :r]
        gxs.append(gx)
    return ys, gxs


@pytest.mark.parametrize("world_size", [2, 4])
def test_halo_exchange_slabs_zero_ends_and_gradient(world_size, world2, world4):
    results, L = (world2, 3) if world_size == 2 else (world4, 2)
    for r in ((1, 2, 3) if world_size == 2 else (1, 2)):
        ys, gxs = _expected_halo(world_size, L, r)
        for i, res in enumerate(results):
            y, _, gx = res["halo"][r]
            assert y.shape[1] == L + 2 * r
            np.testing.assert_array_equal(y, ys[i])
            np.testing.assert_array_equal(gx, gxs[i])
        assert not results[0]["halo"][r][0][:, :r].any()
        assert not results[-1]["halo"][r][0][:, -r:].any()
    assert all(res["halo"]["raises"] for res in results)


def test_halo_exchange_raises_past_the_slab():
    with pytest.raises(ValueError):
        halo_exchange(torch.zeros(1, 2, 3, 3, 1), 3, None)


def _jax_conv(k, dil, groups):
    import jax
    from deformablelka_tpu.parallel.mesh import make_mesh as jmake_mesh
    from deformablelka_tpu.parallel.spatial import spatial_shard_map_conv3d as jconv

    mesh = jmake_mesh(("space",), devices=jax.devices()[:4])
    return jconv(mesh, dilation=dil, groups=groups)


@pytest.mark.parametrize("case", range(len(CONV_CASES)))
def test_spatial_conv_matches_jax_and_unsharded(case, world4):
    import jax
    import jax.numpy as jnp

    k, dil, dw = CONV_CASES[case]
    x, w, b, g, groups = _conv_inputs(k, dw)
    f = _jax_conv(k, dil, groups)
    ref = np.asarray(f(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    unsharded = conv3d(torch.from_numpy(x), _torch_w(w), torch.from_numpy(b),
                       padding=dil * (k // 2), dilation=dil, groups=groups).numpy()
    for r in world4:
        np.testing.assert_allclose(r["convs"][case][0], ref, atol=1e-5, rtol=0)
        np.testing.assert_allclose(r["convs"][case][0], unsharded, atol=1e-5, rtol=0)
    # the gradient through the halos, against jax.grad through the shard_map
    gx_ref, gw_ref, gb_ref = jax.grad(
        lambda x, w, b: jnp.sum(f(x, w, b) * g), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    gx = np.concatenate([r["convs"][case][1] for r in world4], 1)
    gw = sum(r["convs"][case][2] for r in world4)
    gb = sum(r["convs"][case][3] for r in world4)
    for got, want in ((gx, np.asarray(gx_ref)),
                      (gw, np.asarray(gw_ref).transpose(4, 3, 0, 1, 2)),
                      (gb, np.asarray(gb_ref))):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(want).max()))


def _jax_dp_sp_step(params, x, y):
    """`__graft_entry__._dryrun_dp_sp(4)`'s step, returning what it prints."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from deformablelka_tpu.parallel.mesh import make_mesh as jmake_mesh
    from deformablelka_tpu.parallel.spatial import shard_map, spatial_conv3d as jspatial

    mesh = jmake_mesh(("data", "space"), devices=jax.devices("cpu")[:4], shape=(2, 2))

    def local_loss(params, x, y):
        h = jax.nn.relu(jspatial(x, params["w1"], "space"))
        h = jax.nn.relu(jspatial(h, params["w2"], "space"))
        logits = jspatial(h, params["w3"], "space")
        logp = jax.nn.log_softmax(logits, axis=-1)
        ce = -jnp.take_along_axis(logp, y[..., None], axis=-1).sum()
        return lax.psum(ce, ("data", "space"))

    sharded_loss = shard_map(local_loss, mesh=mesh,
                             in_specs=(P(), P("data", "space"), P("data", "space")),
                             out_specs=P())

    def step(params, x, y):
        loss, grads = jax.value_and_grad(lambda p: sharded_loss(p, x, y) / y.size)(params)
        return jax.tree_util.tree_map(lambda p, g: p - 1e-2 * g, params, grads), loss

    repl = NamedSharding(mesh, P())
    vol = NamedSharding(mesh, P("data", "space"))
    new, loss = jax.jit(step, in_shardings=(repl, vol, vol), out_shardings=(repl, repl))(
        jax.device_put({k: jnp.asarray(v) for k, v in params.items()}, repl),
        jax.device_put(jnp.asarray(x), vol), jax.device_put(jnp.asarray(y), vol))
    return {k: np.asarray(v) for k, v in new.items()}, float(loss)


def test_dp_sp_step_matches_jax(world4):
    params, x, y = _dp_sp_inputs()
    ref, ref_loss = _jax_dp_sp_step(params, x, y)
    for r in world4:
        new, loss = r["dp_sp"]
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
        for k in ref:
            np.testing.assert_allclose(new[k], ref[k].transpose(4, 3, 0, 1, 2), rtol=1e-5,
                                       atol=0, err_msg=k)
        for k in new:  # every rank holds the same parameters
            assert np.array_equal(new[k], world4[0]["dp_sp"][0][k]), k
