"""Multi-device inference: a 1-D mesh of devices and the helpers that split
a batch axis over it (`mesh.py`)."""

from propainter_tpu_torch.parallel.mesh import (  # noqa: F401
    canonical_device, make_mesh, map_shards, replicate, split_batch)
