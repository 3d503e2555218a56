"""Data parallelism of the port: one process a card in a
`torch.distributed` group, each rank on its rows of the global batch, with
explicit collectives where a statistic spans the batch (`distributed`),
and the placement helpers that remain without a mesh (`mesh`)."""

from torch_semantic_segmentation_tpu_torch.parallel.mesh import (
    replicate,
    shard_batch,
)

__all__ = ["replicate", "shard_batch"]
