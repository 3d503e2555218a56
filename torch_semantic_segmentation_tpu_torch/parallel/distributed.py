"""Multi-process data parallelism of the port (the JAX package's
`parallel/distributed.py`): one process a card, joined by a
`torch.distributed` process group.

The JAX package runs one process a host and lets GSPMD compile every
reduction over the global batch into the step. Here each rank runs the
ordinary one-device step on its rows of the global batch, and the few
places where a statistic spans the batch call the collectives below
explicitly:

- BatchNorm's moments (`ops.conv.BatchNorm2d`) and the folded moments of
  K2's train-mode BN (`ops.folded_bn`), with gradients through them;
- every loss's weighted-mean denominator and OHEM's k-th largest loss
  (`losses`);
- the gradients (`all_reduce_gradients`, one collective a step);
- the confusion matrix, once at the end of `eval.evaluate`.

The augmentation and dropout draws are taken at the global batch's size
and sliced (`shard_rows`), so rank r sees rows r of the single-process
draw. With no process group every collective here is the identity and
launches nothing, so a single-process run executes exactly the code it
always did.

`initialize()` follows torchrun's contract: `WORLD_SIZE`, `RANK`,
`LOCAL_RANK`, and `MASTER_ADDR` / `MASTER_PORT` for `env://`. NCCL on the
card (rank r on `cuda:LOCAL_RANK`), gloo when the caller asks for the
CPU; `backend="gloo"` on the card puts several ranks on one card, which
NCCL refuses.

    torchrun --nproc-per-node 2 -m torch_semantic_segmentation_tpu_torch.cli.train \\
        --multihost --device cpu --dataset synthetic --max-iterations 3
"""

from __future__ import annotations

import os
import typing as tp

import torch
import torch.distributed as dist

ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK")

_device: torch.device | None = None

# collectives launched since the last reset (none without a group)
collectives = 0


def initialize(device: str | torch.device | None = None, *,
               backend: str | None = None,
               init_method: str = "env://") -> torch.device:
    """Join the process group described by torchrun's environment and
    return this rank's device. `device=None` (or "cuda") is
    `cuda:LOCAL_RANK`, made the current device; "cpu" runs the rank on the
    CPU. `backend` defaults to NCCL on the card and gloo on the CPU. A
    second call in a process with a group returns the group's device.
    Raises when a variable is missing, when there is no card or NCCL for a
    card's rank, or when LOCAL_RANK names no card."""
    global _device
    if dist.is_initialized():
        return _device
    missing = [k for k in ENV if k not in os.environ]
    if init_method == "env://":
        missing += [k for k in ("MASTER_ADDR", "MASTER_PORT")
                    if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"initialize() needs torchrun's environment; {missing} not set "
            "(run under torchrun, or set WORLD_SIZE, RANK, LOCAL_RANK, "
            "MASTER_ADDR and MASTER_PORT)")
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    local_rank = int(os.environ["LOCAL_RANK"])
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' for a CPU rank")
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local_rank} names cuda:"
                               f"{dev.index}; this host has "
                               f"{torch.cuda.device_count()} cards")
        torch.cuda.set_device(dev)
        backend = backend or "nccl"
    elif dev.type == "cpu":
        backend = backend or "gloo"
    else:
        raise ValueError(f"no process group for device {dev}")
    if backend == "nccl" and (dev.type != "cuda"
                              or not dist.is_nccl_available()):
        raise RuntimeError(f"NCCL is not available for {dev}")
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        device_id=dev if backend == "nccl" else None)
    _device = dev
    return dev


def destroy() -> None:
    """Leave the process group (a no-op without one)."""
    global _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _device = None


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def device() -> torch.device | None:
    """This rank's device, or None without a group."""
    return _device if is_initialized() else None


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_multiprocess() -> bool:
    return world_size() > 1


def local_shard_range(global_batch: int) -> tuple[int, int]:
    """[lo, hi) rows of each global batch that this rank feeds: rank r
    takes [r·B/R, (r+1)·B/R). Raises unless B % R == 0."""
    n = world_size()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} processes")
    per = global_batch // n
    r = rank()
    return r * per, (r + 1) * per


def shard_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Rank r's equal share of `x` along `dim` (x itself without a
    group): the rows of a draw made at the global batch's size."""
    n = world_size()
    if n == 1:
        return x
    per = x.shape[dim] // n
    return x.narrow(dim, rank() * per, per)


def local_batch_iterator(dataset, global_batch: int, *,
                         device: str | torch.device | None = None,
                         label_lut=None, start_batch: int = 0,
                         native: bool = False, prefetch: int = 2,
                         **loader_kwargs):
    """This rank's input stream: its slice of every global batch of the
    deterministic (seed, epoch)-keyed order, decoded by `batch_iterator`
    (or the native loader) and copied to `device` by the pinned prefetch.
    Yields (images, labels) uint8 tensors of B/R rows: the rank's slice is
    its batch, and no global array is built."""
    from torch_semantic_segmentation_tpu_torch.data.pipeline import (
        batch_iterator, prefetch_to_device)

    lo, hi = local_shard_range(global_batch)
    if native:
        from torch_semantic_segmentation_tpu_torch.data.native_loader import (
            native_batch_iterator)
        host = native_batch_iterator(dataset, global_batch,
                                     label_lut=label_lut,
                                     start_batch=start_batch,
                                     sample_slice=(lo, hi), **loader_kwargs)
    else:
        host = batch_iterator(dataset, global_batch, label_lut=label_lut,
                              start_batch=start_batch, sample_slice=(lo, hi),
                              **loader_kwargs)
    yield from prefetch_to_device(host, size=prefetch, device=device)


def _count() -> None:
    global collectives
    collectives += 1


def _reduce(x: torch.Tensor, op) -> torch.Tensor:
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op)
    _count()
    return y


class _AllReduceSum(torch.autograd.Function):
    """A SUM all-reduce whose backward is a SUM all-reduce of the
    cotangents: each rank's input gets the gradient of the sum of every
    rank's loss share."""

    @staticmethod
    def forward(ctx, x):
        return _reduce(x, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, dist.ReduceOp.SUM)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over ranks of `x`, with gradients (x itself without a group)."""
    if not is_initialized():
        return x
    return _AllReduceSum.apply(x)


def reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over ranks of `x`, no gradient (x itself without a group)."""
    if not is_initialized():
        return x
    return _reduce(x, dist.ReduceOp.SUM)


def reduce_max(x: torch.Tensor) -> torch.Tensor:
    """Elementwise max over ranks of `x`, no gradient."""
    if not is_initialized():
        return x
    return _reduce(x, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every rank's `x` concatenated along dim 0 in rank order, no
    gradient (x itself without a group). Every rank's x has one shape."""
    if not is_initialized():
        return x
    x = x.detach().contiguous()
    out = torch.empty((world_size() * x.shape[0], *x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x)
    _count()
    return out


def all_reduce_gradients(params: tp.Iterable[torch.Tensor]) -> None:
    """Sum the gradients over ranks in place: one collective for each
    dtype, over the flattened gradients (parameters without a gradient,
    the same on every rank, are left out)."""
    if not is_initialized():
        return
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        _count()
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def barrier() -> None:
    if is_initialized():
        dist.barrier()
