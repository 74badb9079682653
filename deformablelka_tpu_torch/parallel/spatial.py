"""Spatial (depth) sharding: halo-exchange convs, and the data × space step.

Port of `deformablelka_tpu/parallel/spatial.py`, with `_dryrun_dp_sp` of
the JAX package's `__graft_entry__.py` beside it. Each rank of a "space"
axis holds a contiguous D/n slab of the volume; before a stencil of
depth radius r, neighbours swap their r-deep boundary slabs (two
point-to-point shifts, up and down the line), and the conv runs on the
haloed slab with 'valid' depth and 'same' H/W. The two end ranks take
zero slabs, as 'same' zero padding would give.

- `halo_exchange(x, radius, group)` is the exchange, a
  `torch.autograd.Function`: its backward is the transpose of the two
  shifts. It sends each halo's gradient back to the neighbour that owns
  the slab and adds it into that neighbour's boundary gradient
  (`torch.distributed`'s point-to-point ops carry no autograd).
- `spatial_conv3d(x, w, group)` is the stencil on a local slab.
- `spatial_shard_map_conv3d(mesh, axis)` is the whole-volume function:
  global tensor in, this rank's slab through `spatial_conv3d`, the slabs
  all-gathered out.
- `dp_sp_step` is the data × space training step on a ("data", "space")
  mesh: a stack of `spatial_conv3d` layers and a CE summed over both
  axes.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn

from deformablelka_tpu_torch.ops.convs import _tuple, conv3d
from deformablelka_tpu_torch.training.train_step import sum_gradients


def _swap(sends: list, recvs: list, group) -> None:
    """Post every (tensor, group rank) send and receive at once; wait."""
    ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(group, peer), group)
           for t, peer in sends]
    ops += [dist.P2POp(dist.irecv, t, dist.get_global_rank(group, peer), group)
            for t, peer in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _group(group):
    return dist.group.WORLD if group is None else group


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, radius, group, dim):
        n, idx = dist.get_world_size(group), dist.get_rank(group)
        L = x.shape[dim]
        ctx.radius, ctx.group, ctx.dim, ctx.extent = radius, group, dim, L
        lo = x.narrow(dim, 0, radius).contiguous()
        hi = x.narrow(dim, L - radius, radius).contiguous()
        from_prev, from_next = torch.zeros_like(lo), torch.zeros_like(hi)
        sends, recvs = [], []
        if idx > 0:        # my bottom slab is the previous rank's upper halo
            sends.append((lo, idx - 1))
            recvs.append((from_prev, idx - 1))
        if idx < n - 1:    # my top slab is the next rank's lower halo
            sends.append((hi, idx + 1))
            recvs.append((from_next, idx + 1))
        _swap(sends, recvs, group)
        return torch.cat([from_prev, x, from_next], dim)

    @staticmethod
    def backward(ctx, g):
        r, group, dim, L = ctx.radius, ctx.group, ctx.dim, ctx.extent
        n, idx = dist.get_world_size(group), dist.get_rank(group)
        g_prev = g.narrow(dim, 0, r).contiguous()       # owned by idx - 1's top
        g_next = g.narrow(dim, r + L, r).contiguous()   # owned by idx + 1's bottom
        dx = g.narrow(dim, r, L).clone()
        to_lo, to_hi = torch.zeros_like(g_prev), torch.zeros_like(g_next)
        sends, recvs = [], []
        if idx > 0:
            sends.append((g_prev, idx - 1))
            recvs.append((to_lo, idx - 1))
        if idx < n - 1:
            sends.append((g_next, idx + 1))
            recvs.append((to_hi, idx + 1))
        _swap(sends, recvs, group)
        dx.narrow(dim, 0, r).add_(to_lo)
        dx.narrow(dim, L - r, r).add_(to_hi)
        return dx, None, None, None


def halo_exchange(x: torch.Tensor, radius: int, group=None, *, dim: int = 1):
    """Append each neighbour's boundary slab of depth `radius` along `dim`
    (zero slabs at the line's two ends). x: this rank's (B, D/n, ..., C)
    slab; `group`: the ranks of the sharded axis, in order (None: the
    world). Returns the haloed slab of extent D/n + 2·radius."""
    if radius > x.shape[dim]:
        raise ValueError(
            f"halo radius {radius} exceeds the local slab extent {x.shape[dim]}: use "
            "fewer shards or a smaller stencil (the exchange reaches only the "
            "immediate neighbours)")
    if radius == 0:
        return x
    return _HaloExchange.apply(x, radius, _group(group), dim)


def spatial_conv3d(x, w, group=None, *, bias=None, dilation=1, groups: int = 1):
    """'same'-padded stride-1 3D conv of a depth-sharded volume. x: this
    rank's slab (B, D/n, H, W, Cin); w: (Cout, Cin // groups, kd, kh, kw),
    as `ops.convs.conv3d`. The depth radius dil·(kd // 2) is exchanged with
    the neighbours; H and W are local."""
    kd, kh, kw = w.shape[2:]
    dil = _tuple(dilation, 3)
    r = dil[0] * (kd // 2)
    if r > 0:
        x = halo_exchange(x, r, group, dim=1)
    return conv3d(x, w, bias, padding=(0, dil[1] * (kh // 2), dil[2] * (kw // 2)),
                  dilation=dilation, groups=groups)


def spatial_shard_map_conv3d(mesh, axis: str = "space", *, dilation=1,
                             groups: int = 1):
    """The whole-volume 'same' 3D conv with the volume depth-sharded over
    `axis`: f(x, w, bias) takes the global (B, D, H, W, Cin) tensor on
    every rank, runs this rank's D/n slab and returns the global output,
    all-gathered (differentiably) over the axis."""
    group, n, i = mesh.group(axis), mesh.size(axis), mesh.coordinate(axis)

    def f(x, w, bias=None):
        if x.shape[1] % n:
            raise ValueError(f"depth {x.shape[1]} does not divide over {n} ranks")
        per = x.shape[1] // n
        local = spatial_conv3d(x.narrow(1, i * per, per), w, group, bias=bias,
                               dilation=dilation, groups=groups)
        return torch.cat(dist_nn.all_gather(local.contiguous(), group=group), 1)

    return f


def dp_sp_step(params: dict, x, y, mesh, lr: float = 1e-2):
    """One SGD step of `__graft_entry__._dryrun_dp_sp` on a ("data",
    "space") mesh. The loss: three `spatial_conv3d` layers (3³ → ReLU → 3³
    → ReLU → 1³) on this rank's slab x (B/n_dp, D/n_sp, H, W, 1), the CE of
    labels y summed over the slab and the global sum divided by the global
    voxel count. Each rank differentiates its own CE over that count, and
    the gradients summed over the world are the global loss's (JAX psums
    the CE); p ← p − lr · g on every rank. Returns (new params, loss)."""
    sp = mesh.group("space")
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    h = torch.relu(spatial_conv3d(x, leaves["w1"], sp))
    h = torch.relu(spatial_conv3d(h, leaves["w2"], sp))
    logp = torch.log_softmax(spatial_conv3d(h, leaves["w3"], sp).float(), dim=-1)
    ce = -torch.gather(logp, -1, y.long()[..., None]).sum()
    share = ce / (y.numel() * mesh.size("data") * mesh.size("space"))
    share.backward()
    sum_gradients(leaves.values())
    loss = share.detach().clone()
    dist.all_reduce(loss)
    return {k: (p - lr * p.grad).detach() for k, p in leaves.items()}, loss
