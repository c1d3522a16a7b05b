"""Scale-out of the port over torch.distributed (counterpart of
remixfusion_tpu.parallel): launch.py starts the ranks and holds the
collectives, sharding.py the sharded map steps and fusion, dryrun.py a
multi-rank run of them all."""

from remixfusion_tpu_torch.parallel.launch import (  # noqa: F401
    Collectives, make_group, spawn)
from remixfusion_tpu_torch.parallel.sharding import (  # noqa: F401
    SlabGrid, gridsharded_map_train_step, pad_rows_for_mesh,
    partition_tiles_by_device, sharded_fuse_frame, sharded_fuse_pack_gbq,
    sharded_map_train_step, slab_bounds)
