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
rows of a global batch that a caller holds whole, and with `spatial=True`
its band of each image's rows. The 'spatial' axis is
`distributed.initialize(num_spatial=...)`; `shard_batch` refuses what the
JAX package refuses: an H that the spatial ranks do not divide (the
words of JAX's `device_put`) and a degenerate split
(`check_spatial_extent`, the JAX package's guard). Bands may be unequal
(`distributed.split_rows`: whole blocks of `max_stride` rows, so every
stride-2 stage stays on the global grid), where the JAX package lets
GSPMD pad.
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


def check_spatial_extent(input_h: int, num_spatial: int,
                         max_stride: int = 32) -> None:
    """The JAX package's guard against degenerate spatial shards: raises
    ValueError where the network's deepest feature map (input_h /
    max_stride rows) has fewer rows than there are spatial ranks, so that
    some band there would hold no row. In the JAX package GSPMD then
    overcounts that stage's backward by the axis size."""
    deepest = input_h // max_stride
    if deepest < num_spatial:
        raise ValueError(
            f"degenerate spatial sharding: input H={input_h} reaches "
            f"H={deepest} at stride {max_stride}, smaller than the "
            f"spatial axis ({num_spatial}): some bands would be empty. "
            f"Use input H ≥ {max_stride * num_spatial} or fewer spatial "
            f"ranks.")


def shard_batch(batch, spatial: bool = False, max_stride: int = 32):
    """This rank's part of each array in a global batch (images NHWC,
    labels NHW, ...): its data row's rows [d·B/D, (d+1)·B/D), and with
    `spatial=True` its band of H rows of each, after the JAX package's
    refusals on the images' H (H % num_spatial, `check_spatial_extent`).
    The split (`distributed.split_rows` at `max_stride`) is recorded for
    the band operations that follow (`distributed.record_split`). The
    batch itself without a group. Under spatial sharding the model takes
    bands, so `spatial=False` raises there."""
    n_spatial = distributed.num_spatial()
    if n_spatial > 1 and not spatial:
        raise ValueError(f"the group splits H over {n_spatial} spatial "
                         "ranks: shard the batch with spatial=True")
    lo, hi = distributed.local_shard_range(batch[0].shape[0])
    out = tuple(x[lo:hi] for x in batch)
    if spatial:
        h = batch[0].shape[1]
        check_spatial_extent(h, n_spatial, max_stride)
        split = distributed.split_rows(h, n_spatial, max_stride)
        if n_spatial > 1:
            distributed.record_split(split)
        out = tuple(distributed.band_rows(x, 1) for x in out)
    return out
