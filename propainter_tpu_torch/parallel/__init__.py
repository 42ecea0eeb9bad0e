"""Several devices: a 1-D mesh of devices and the helpers that split a
batch axis over it for inference, and the ranks of data-parallel training
(`mesh.py`)."""

from propainter_tpu_torch.parallel.mesh import (  # noqa: F401
    all_reduce_max, all_reduce_mean, barrier, broadcast_modules,
    canonical_device, free_port, is_main, make_mesh, map_shards,
    maybe_initialize_distributed, rank, replicate, split_batch, world_size)
