"""Ranks, meshes and sharding over `torch.distributed` (the port of
`deformablelka_tpu/parallel/`): `mesh` lays the ranks out on named axes and
shards batches, `spatial` exchanges halos for depth-sharded convs, and
`launch` starts a world of ranks on one machine."""

from deformablelka_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    init_process_group,
    make_mesh,
    replicated,
    shard_batch,
)
