"""Data parallelism and spatial sharding of the port: one process a card
in a `torch.distributed` group, each rank on its rows of the global batch
(and with `num_spatial` > 1 on a band of their H rows), with explicit
collectives where a statistic spans the batch and explicit halo exchanges
where an op reads a neighbouring band's rows (`distributed`), and the
placement helpers that remain without a mesh (`mesh`)."""

from torch_semantic_segmentation_tpu_torch.parallel.mesh import (
    check_spatial_extent,
    replicate,
    shard_batch,
)

__all__ = ["check_spatial_extent", "replicate", "shard_batch"]
