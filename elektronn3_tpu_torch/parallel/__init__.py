"""Meshes, collectives, halo exchange and multi-process setup
(multi-GPU data and spatial parallelism); the JAX package's
``parallel``."""

from elektronn3_tpu_torch.parallel.mesh import (
    Axis,
    Mesh,
    active_mesh,
    batch_sharding,
    data_parallel_mesh,
    make_mesh,
    replicated,
)
from elektronn3_tpu_torch.parallel.collectives import (
    all_gather,
    gather_shards,
    psum,
    stats_group,
    sum_gradients,
)
from elektronn3_tpu_torch.parallel.halo import (
    exchange_halo,
    sharded_spatial_apply,
)
from elektronn3_tpu_torch.parallel.distributed import (
    host_local_batch,
    init_distributed,
    launch,
    local_device,
    make_global_mesh,
    num_processes,
)
from elektronn3_tpu_torch.parallel.dryrun import dryrun_multichip
