"""The port's multi-GPU layer: the mesh, its collectives, frame-sharded sampling."""

from vface_torch.parallel.mesh import (
    BATCH,
    REPLICATED,
    frame_halo_exchange,
    make_mesh,
    pmean,
    replicate,
    shard_batch,
    single_device_mesh,
)

__all__ = [
    "BATCH",
    "REPLICATED",
    "frame_halo_exchange",
    "make_mesh",
    "pmean",
    "replicate",
    "shard_batch",
    "single_device_mesh",
]
