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

Spatial sharding (the JAX package's 'spatial' mesh axis, `num_spatial`):
the world is `world / num_spatial` data rows of `num_spatial` consecutive
ranks. A rank holds its data row's images of the global batch
(`local_shard_range`, `shard_rows`) and an equal band of H rows of each
(`band_rows`). GSPMD inserts the halo exchanges there; here every op that
reads neighbouring rows calls `on_band`: it takes `halo` rows from the
bands above and below (`halo`, an autograd function whose backward sends
each halo row's gradient back to its owner), runs on band + halo and
crops back to the band. A halo longer than a band (ASPP's rate 18 at
1/16) gathers from as many bands as it spans. No halo row is taken past
the image's global top and bottom, where the op's own padding is the
global one. A reduction over H sums the band's part over the data row
(`spatial_sum`, one process subgroup a data row). `world_size()` stays
every rank: each holds an equal share of the global batch's pixels, so
the moments, losses and gradients above still weigh each rank 1/R and
sum every pixel once.

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
_num_spatial = 1
_row_group = None   # this rank's data row: its spatial ranks' subgroup

# collectives launched since the last reset (none without a group)
collectives = 0
# halo exchanges (forward and backward) and the bytes this rank sent in
# them since the last reset
halo_exchanges = 0
halo_bytes = 0


def initialize(device: str | torch.device | None = None, *,
               backend: str | None = None,
               init_method: str = "env://",
               num_spatial: int = 1) -> torch.device:
    """Join the process group described by torchrun's environment and
    return this rank's device. `device=None` (or "cuda") is
    `cuda:LOCAL_RANK`, made the current device; "cpu" runs the rank on the
    CPU. `backend` defaults to NCCL on the card and gloo on the CPU. A
    second call in a process with a group returns the group's device.
    `num_spatial` > 1 splits the world into `world / num_spatial` data
    rows of that many consecutive ranks, each rank on a band of H rows of
    its row's images (the JAX package's `data_parallel_mesh(num_data,
    num_spatial)`), with one subgroup a data row. Raises when a variable
    is missing, when there is no card or NCCL for a card's rank, when
    LOCAL_RANK names no card, or when `num_spatial` does not divide the
    world."""
    global _device, _num_spatial, _row_group
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
    if num_spatial < 1 or world % num_spatial:
        raise ValueError(f"num_spatial={num_spatial} does not divide the "
                         f"world of {world} ranks")
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
    _num_spatial = num_spatial
    if num_spatial > 1:
        # every rank takes part in making every subgroup, in one order
        for row in range(world // num_spatial):
            ranks = list(range(row * num_spatial, (row + 1) * num_spatial))
            group = dist.new_group(ranks)
            if rank in ranks:
                _row_group = group
    return dev


def destroy() -> None:
    """Leave the process group (a no-op without one)."""
    global _device, _num_spatial, _row_group
    if dist.is_initialized():
        dist.destroy_process_group()
    _device, _num_spatial, _row_group = None, 1, None


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


def num_spatial() -> int:
    """Ranks a data row's images are split over along H (1 without a
    group or without spatial sharding)."""
    return _num_spatial if is_initialized() else 1


def is_spatial() -> bool:
    return num_spatial() > 1


def spatial_rank() -> int:
    """This rank's band: 0 holds the images' top rows."""
    return rank() % num_spatial()


def data_size() -> int:
    """The data rows the global batch is split over."""
    return world_size() // num_spatial()


def data_rank() -> int:
    return rank() // num_spatial()


def local_shard_range(global_batch: int) -> tuple[int, int]:
    """[lo, hi) rows of each global batch that this rank feeds: data row d
    takes [d·B/D, (d+1)·B/D), D the data rows (every rank without spatial
    sharding). Raises unless B % D == 0."""
    n = data_size()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} processes")
    per = global_batch // n
    r = data_rank()
    return r * per, (r + 1) * per


def shard_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's data row's equal share of `x` along `dim` (x itself
    without a group): the rows of a draw made at the global batch's
    size."""
    n = data_size()
    if n == 1:
        return x
    per = x.shape[dim] // n
    return x.narrow(dim, data_rank() * per, per)


def band_rows(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's band of `x` along `dim`, the image's H: the rows of a
    draw made at the global H (x itself without spatial sharding)."""
    n = num_spatial()
    if n == 1:
        return x
    per = x.shape[dim] // n
    return x.narrow(dim, spatial_rank() * per, per)


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


def _reduce(x: torch.Tensor, op, group=None) -> torch.Tensor:
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=group)
    _count()
    return y


class _AllReduceSum(torch.autograd.Function):
    """A SUM all-reduce over `group` whose backward is a SUM all-reduce of
    the cotangents: each rank's input gets the gradient of the sum of
    every rank's loss share."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, dist.ReduceOp.SUM, ctx.group), None


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over ranks of `x`, with gradients (x itself without a group)."""
    if not is_initialized():
        return x
    return _AllReduceSum.apply(x, None)


def spatial_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over this rank's data row (its spatial ranks) of `x`, with
    gradients: a reduction over H of the band's parts (x itself without
    spatial sharding)."""
    if not is_spatial():
        return x
    return _AllReduceSum.apply(x, _row_group)


def _exchange(sends: list, recvs: list, like: torch.Tensor) -> list:
    """Point to point within the data row: `sends` are (tensor, spatial
    rank) and `recvs` (shape, spatial rank); returns the received tensors
    on `like`'s device and dtype. NCCL sends the card's tensors; gloo
    sends no CUDA tensor point to point, so under gloo they go through
    host memory."""
    global halo_exchanges, halo_bytes
    base = data_rank() * num_spatial()
    host = dist.get_backend() != "nccl"
    dev = torch.device("cpu") if host else like.device
    out = [torch.empty(shape, dtype=like.dtype, device=dev)
           for shape, _ in recvs]
    payload = [t.detach().to(dev).contiguous() for t, _ in sends]
    if host:
        reqs = ([dist.isend(t, base + peer) for t, (_, peer) in
                 zip(payload, sends)]
                + [dist.irecv(t, base + peer) for t, (_, peer) in
                   zip(out, recvs)])
    else:
        reqs = dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, t, base + peer)
             for t, (_, peer) in zip(payload, sends)]
            + [dist.P2POp(dist.irecv, t, base + peer)
               for t, (_, peer) in zip(out, recvs)]) if sends or recvs else []
    for r in reqs:
        r.wait()
    halo_exchanges += 1
    halo_bytes += sum(t.numel() * t.element_size() for t in payload)
    return [t.to(like.device) for t in out]


def halo_rows(top: int, bottom: int, rows: int) -> tuple[int, int]:
    """(t, b): the rows of a halo of `top` and `bottom` rows that reach a
    band of `rows` rows, this rank's: as many as lie between the band and
    the image's global top and bottom, so none at the image's edges and
    fewer near them (0, 0 without spatial sharding)."""
    if not is_spatial():
        return 0, 0
    s, n = spatial_rank(), num_spatial()
    return min(top, s * rows), min(bottom, (n - 1 - s) * rows)


def _spans(halo: int, rows: int, peers: int) -> list[tuple[int, int]]:
    """[(k, m)]: a halo of `halo` rows over bands of `rows` rows takes m
    rows from the band k away (k = 1 the nearest, a whole band where the
    halo reaches past it), for the `peers` bands there are that way."""
    out = []
    for k in range(1, peers + 1):
        m = min(rows, halo - (k - 1) * rows)
        if m <= 0:
            break
        out.append((k, m))
    return out


class _Halo(torch.autograd.Function):
    """Band + halo along dim 1 (H of NHWC and NHW): `top` rows from the
    bands above and `bottom` from the bands below, from as many bands as
    the halo spans (the nearest band's last or first rows, then the next
    one's, ...), none past the image's global top and bottom. Each pair of
    bands exchanges at most one message each way. The backward sends each
    halo row's gradient back to the band it came from, which adds it to
    its own row's."""

    @staticmethod
    def forward(ctx, x, top: int, bottom: int):
        s, n = spatial_rank(), num_spatial()
        rows = x.shape[1]
        # what this band gives: its last rows to the bands below (their
        # top halos), its first rows to the bands above (their bottom)
        give_down = _spans(top, rows, n - 1 - s)
        give_up = _spans(bottom, rows, s)
        # what it takes: the top halo farthest band first, the bottom
        # halo nearest first, in the order the rows lie
        above = _spans(top, rows, s)[::-1]
        below = _spans(bottom, rows, n - 1 - s)
        ctx.plan = (rows, give_down, give_up, above, below)
        sends = ([(x[:, rows - m:], s + k) for k, m in give_down]
                 + [(x[:, :m], s - k) for k, m in give_up])
        recvs = ([((x.shape[0], m, *x.shape[2:]), s - k) for k, m in above]
                 + [((x.shape[0], m, *x.shape[2:]), s + k)
                    for k, m in below])
        got = _exchange(sends, recvs, x)
        return torch.cat([*got[:len(above)], x, *got[len(above):]], dim=1)

    @staticmethod
    def backward(ctx, g):
        rows, give_down, give_up, above, below = ctx.plan
        s = spatial_rank()
        t = sum(m for _, m in above)
        sends, at = [], 0
        for k, m in above:
            sends.append((g[:, at:at + m], s - k))
            at += m
        at += rows
        for k, m in below:
            sends.append((g[:, at:at + m], s + k))
            at += m
        recvs = ([((g.shape[0], m, *g.shape[2:]), s + k)
                  for k, m in give_down]
                 + [((g.shape[0], m, *g.shape[2:]), s - k)
                    for k, m in give_up])
        got = _exchange(sends, recvs, g)
        dx = g[:, t:t + rows].clone()
        for (_, m), d in zip(give_down, got[:len(give_down)]):
            dx[:, rows - m:] += d
        for (_, m), d in zip(give_up, got[len(give_down):]):
            dx[:, :m] += d
        return dx, None, None


def halo(x: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
    """x (N, H, ...) with `top` rows of the bands above before it and
    `bottom` rows of the bands below after it, gathered from as many bands
    as they span and none past the image's global top and bottom
    (`halo_rows` says how many arrive; x itself without spatial
    sharding); gradients go back to their bands."""
    if not is_spatial() or not (top or bottom):
        return x
    if min(top, bottom) < 0:
        raise ValueError(f"a halo of {top}, {bottom} rows")
    return _Halo.apply(x, top, bottom)


def on_band(fn, x: torch.Tensor, top: int, bottom: int, up: int = 1,
            down: int = 1) -> torch.Tensor:
    """`fn` of this rank's band of the global tensor: `fn(halo(x, top,
    bottom))` cropped to the band's rows of the global result. `fn` maps
    R input rows to R·up/down output rows from the same origin (a conv of
    stride `down`, whose `top` is a multiple of it; a ×`up` resize), so
    the band's rows start at t·up/down, t the top halo rows that arrived
    (`halo_rows`). Where a halo stops at the image's global top or bottom,
    `fn`'s own padding falls where the single process pads. A band whose
    rows the stride does not divide raises: its rows of the result would
    not start on the global grid. Without spatial sharding, `fn(x)`."""
    if not is_spatial():
        return fn(x)
    if x.shape[1] * up % down:
        raise ValueError(f"a band of {x.shape[1]} rows is off the "
                         f"stride-{down} grid")
    t, _ = halo_rows(top, bottom, x.shape[1])
    if t * up % down:
        raise ValueError(f"a top halo of {t} rows is off the stride-{down} "
                         "grid")
    y = fn(halo(x, top, bottom))
    rows = x.shape[1] * up // down
    start = t * up // down
    if y.shape[1] < start + rows:
        raise ValueError(f"{y.shape[1]} rows out of a band + halo of "
                         f"{x.shape[1]} + {top} + {bottom}: not the "
                         f"{start} + {rows} the band needs")
    return y.narrow(1, start, rows)


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
