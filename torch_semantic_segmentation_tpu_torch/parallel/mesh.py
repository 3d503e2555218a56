"""Placement helpers of the port's data parallelism (the JAX package's
`parallel/mesh.py`).

A process group has no mesh. In the JAX package `data_parallel_mesh`,
`batch_sharding`, `label_sharding` and the `hybrid_*` pair only annotate
where GSPMD should place the batch and the parameters; here every rank
holds its own rows (`distributed.local_shard_range`) and a full copy of
the model, so those have no object of their own. The hybrid
('dcn_data', 'data') mesh buys ICI inside a slice and DCN between slices;
NCCL picks NVLink inside a node and the network between nodes by itself.

What remains is what a caller does by hand: `replicate` makes every
rank's parameters and buffers rank 0's, and `shard_batch` takes rank r's
rows of a global batch that a caller holds whole. Spatial sharding (the
'spatial' axis and `check_spatial_extent`) is not in the port.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from torch_semantic_segmentation_tpu_torch.parallel import distributed


def replicate(module: nn.Module) -> nn.Module:
    """Broadcast `module`'s parameters and buffers from rank 0 to every
    rank, in place (a no-op without a group). Returns the module."""
    if distributed.is_initialized():
        with torch.no_grad():
            for t in [*module.parameters(), *module.buffers()]:
                dist.broadcast(t.data, src=0)
    return module


def shard_batch(batch):
    """Rank r's rows [r·B/R, (r+1)·B/R) of each array in a global batch
    (images NHWC, labels NHW, ...); the batch itself without a group."""
    lo, hi = distributed.local_shard_range(batch[0].shape[0])
    return tuple(x[lo:hi] for x in batch)
