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
(`local_shard_range`, `shard_rows`) and a band of H rows of each. The
split of H over the bands is one record (`split_rows`, `record_split`),
made by whoever cuts bands (`parallel.shard_batch`, the multi-scale eval
step for each scale's image): where H is a multiple of the model's
`max_stride` the H / max_stride blocks of that many rows are dealt as
evenly as they go, the first bands taking one more, so every stride-2
stage of every band stays on the global grid; any other H splits into
H / num_spatial equal rows, as the JAX package's `device_put` splits it.
Every band operation reads its band's global offset, the global rows and
its neighbours' rows from that record, scaled to the level it runs at
(`band_split`, `band_start`, `global_rows`). GSPMD inserts the halo
exchanges there; here every op that reads neighbouring rows calls
`on_band`: it takes `halo` rows from the bands above and below (`halo`,
an autograd function whose backward sends each halo row's gradient back
to its owner), runs on band + halo and crops back to the band. A halo
longer than a band (ASPP's rate 18 at 1/16) gathers from as many bands as
it spans. No halo row is taken past the image's global top and bottom,
where the op's own padding is the global one. A reduction over H sums
the band's part over the data row (`spatial_sum`, one process subgroup a
data row). `world_size()` stays every rank; the moments weigh each rank
by its share of the global batch's pixels (`pixel_share`), and the losses
and gradients sum every pixel once. A checkpointed segment's recompute
exchanges its halos again, as `jax.checkpoint` reruns GSPMD's exchanges:
the exchanges block, and every rank runs them in one order. The JAX
package's sharding travels with the array; here the steps check that
their images and labels are the rank's band of the record (`check_band`),
so that a batch cut by other means raises instead of reading another
split.

`initialize()` follows torchrun's contract: `WORLD_SIZE`, `RANK`,
`LOCAL_RANK`, and `MASTER_ADDR` / `MASTER_PORT` for `env://`. NCCL on the
card (rank r on `cuda:LOCAL_RANK`), gloo when the caller asks for the
CPU; `backend="gloo"` on the card puts several ranks on one card, which
NCCL refuses.

    torchrun --nproc-per-node 2 -m torch_semantic_segmentation_tpu_torch.cli.train \\
        --multihost --device cpu --dataset synthetic --max-iterations 3
"""

from __future__ import annotations

import contextlib
import os
import typing as tp

import torch
import torch.distributed as dist

ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK")

_device: torch.device | None = None
_num_spatial = 1
_row_group = None   # this rank's data row: its spatial ranks' subgroup
# the split of the image last cut into bands: each band's rows, top first
# (None: equal bands)
_split: tuple[int, ...] | None = None
# depth of `replicated()` blocks
_replicated = 0

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
    global _device, _num_spatial, _row_group, _split
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
    _split = None
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
    global _device, _num_spatial, _row_group, _split
    if dist.is_initialized():
        dist.destroy_process_group()
    _device, _num_spatial, _row_group, _split = None, 1, None, None


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


def split_rows(h: int, n: int, max_stride: int = 1) -> tuple[int, ...]:
    """The rows of each of `n` bands of an image of `h` rows, top first:
    where `max_stride` divides h, its h / max_stride blocks of max_stride
    rows dealt as evenly as they go, the first bands taking one more (160
    on 4 bands at 32: 64/32/32/32); any other h in h / n equal rows, as
    the JAX package's `device_put` splits it. Raises ValueError, in the
    words of that refusal, where n does not divide h."""
    if h % n:
        raise ValueError(
            f"One of device_put args was given the sharding of "
            f"NamedSharding(spatial={n}), which implies that the global size "
            f"of its dimension 1 should be divisible by {n}, but it is "
            f"equal to {h} (full shape: H={h})")
    if h % max_stride:
        return (h // n,) * n
    q, r = divmod(h // max_stride, n)
    return tuple((q + (i < r)) * max_stride for i in range(n))


def record_split(split: tp.Sequence[int] | None) -> None:
    """Record the split (each band's rows, top first) of the image that
    the band operations run on from now on: `parallel.shard_batch` records
    the batch's. None records equal bands."""
    global _split
    _split = None if split is None else tuple(int(r) for r in split)


@contextlib.contextmanager
def recorded_split(split: tp.Sequence[int] | None):
    """Within the block the band operations run on an image of `split`
    (the multi-scale eval step's scaled image); the record before it comes
    back after."""
    saved = _split
    record_split(split)
    try:
        yield
    finally:
        record_split(saved)


def band_split(rows: int, split: tp.Sequence[int] | None = None
               ) -> tuple[int, ...]:
    """Each band's rows at the level where this band has `rows`: the
    image's split (`split`, or the record) scaled by rows over this band's
    rows in it, so that every band of a stride-s stage holds its image
    rows / s. Without a record, equal bands. Raises ValueError where the
    scaled split is not whole rows: `rows` lies at no level of it."""
    n = num_spatial()
    base = _split if split is None else tuple(split)
    if base is None:
        return (rows,) * n
    if len(base) != n:
        raise ValueError(f"a split of {len(base)} bands under "
                         f"{n} spatial ranks")
    mine = base[spatial_rank()]
    if any(r * rows % mine for r in base):
        raise ValueError(f"a band of {rows} rows is at no level of the "
                         f"split {base}")
    return tuple(r * rows // mine for r in base)


def check_band(rows: int, what: str) -> None:
    """Raise ValueError unless a band of `rows` rows is this rank's band of
    the recorded split, the one `parallel.shard_batch` cut: the steps call
    it on the images' and the labels' H before the model runs, so that a
    band cut by other means fails on its own rank before any collective
    or halo, and its peers at their first exchange with it. A no-op
    without a record (equal bands) and where the tensors are not bands."""
    if _split is None or not _banded():
        return
    s = spatial_rank()
    want = _split[s] if s < len(_split) else None
    if rows != want:
        raise ValueError(
            f"{what}: band {s} has {rows} rows, where the recorded split "
            f"{_split} gives it {want}: cut the batch with "
            "parallel.shard_batch(spatial=True)")


def band_start(rows: int, split: tp.Sequence[int] | None = None) -> int:
    """This band's first row in the global rows (`band_split`)."""
    return sum(band_split(rows, split)[:spatial_rank()])


def global_rows(rows: int) -> int:
    """The image's rows at the level where this band has `rows` (rows
    itself without spatial sharding, and for a tensor the same on every
    band, within `replicated()`)."""
    if not _banded():
        return rows
    return sum(band_split(rows))


def global_split(h: int) -> tuple[int, ...]:
    """The record scaled to an image of `h` global rows (a draw made at
    the global H); equal bands without a record. Raises ValueError where
    that is not whole rows."""
    n = num_spatial()
    if _split is None:
        if h % n:
            raise ValueError(f"{h} rows do not split into {n} bands")
        return (h // n,) * n
    total = sum(_split)
    if any(r * h % total for r in _split):
        raise ValueError(f"{h} global rows are at no level of the split "
                         f"{_split}")
    return tuple(r * h // total for r in _split)


def largest_band(rows: int) -> int:
    """The rows of the largest band at the level where this band has
    `rows` (rows itself without spatial sharding)."""
    return max(band_split(rows)) if _banded() else rows


def band_rows(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's band of `x` along `dim`, the image's H: the rows of a
    draw made at the global H, cut as the record splits it (x itself
    without spatial sharding)."""
    if num_spatial() == 1:
        return x
    split = global_split(x.shape[dim])
    s = spatial_rank()
    return x.narrow(dim, sum(split[:s]), split[s])


@contextlib.contextmanager
def replicated():
    """Within the block the tensors are the same on every band of a data
    row (a global pool's, the PPM's bins), whole on each, not bands: the
    ops take no halo (`halo`, `on_band`), their global rows are their own
    and `pixel_share` weighs their ranks equally."""
    global _replicated
    _replicated += 1
    try:
        yield
    finally:
        _replicated -= 1


def _banded() -> bool:
    """Whether the tensors are bands: spatial sharding, outside
    `replicated()`."""
    return is_spatial() and not _replicated


def pixel_share(rows: int) -> float:
    """This rank's share of the global batch's pixels for a tensor whose
    band has `rows` rows: its band's rows over the global rows, over the
    data rows (equal shares of the batch, `local_shard_range`); 1/R
    without spatial sharding, within `replicated()`, and on equal bands
    (bit for bit: r / (r·R) rounds as 1/R does)."""
    if not _banded():
        return 1.0 / world_size()
    return rows / (global_rows(rows) * data_size())


def global_pixels(count: int, rows: int) -> int:
    """The global batch's count of the values of which this rank holds
    `count`, on its band of `rows` rows (count · R without spatial
    sharding)."""
    if not _banded():
        return count * world_size()
    return count // rows * global_rows(rows) * data_size()


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
    the image's global top and bottom (`band_split`), so none at the
    image's edges and fewer near them (0, 0 without spatial sharding)."""
    if not _banded():
        return 0, 0
    split = band_split(rows)
    lo = sum(split[:spatial_rank()])
    return min(top, lo), min(bottom, sum(split) - lo - rows)


def _windows(split: tuple[int, ...], top: int, bottom: int) -> tuple:
    """Each band's [first, end) global rows with a halo of `top` and
    `bottom` rows, stopped at the image's edges."""
    out, lo, h = [], 0, sum(split)
    for r in split:
        out.append((max(0, lo - top), min(h, lo + r + bottom)))
        lo += r
    return tuple(out)


def _parts(split: tuple[int, ...], windows: tuple) -> list:
    """[(k, j, first, end)]: the global rows [first, end) of band k that
    band j's window holds besides its own, for every pair k ≠ j with
    some, in the order of (k, j)."""
    starts = [sum(split[:k]) for k in range(len(split))]
    out = []
    for k, (s0, r) in enumerate(zip(starts, split)):
        for j, (a, b) in enumerate(windows):
            lo, hi = max(a, s0), min(b, s0 + r)
            if k != j and lo < hi:
                out.append((k, j, lo, hi))
    return out


class _Halo(torch.autograd.Function):
    """Band + halo along dim 1 (H of NHWC and NHW): band j's window of
    global rows `windows[j]` (its own rows within it) on the bands of
    `split`, gathered from as many bands as the window spans (the rows
    above first, in the order they lie). Each pair of bands exchanges at
    most one message each way, and every rank derives the same pairs from
    the same split and windows, so the sending and the receiving side
    agree. The backward sends each halo row's gradient back to the band
    it came from, which adds it to its own row's."""

    @staticmethod
    def forward(ctx, x, split, windows):
        s = spatial_rank()
        start = sum(split[:s])
        parts = _parts(split, windows)
        give = [(j, lo - start, hi - lo) for k, j, lo, hi in parts if k == s]
        take = [(k, hi - lo) for k, j, lo, hi in parts if j == s]
        ctx.plan = (give, take, x.shape[1])
        sends = [(x[:, at:at + m], j) for j, at, m in give]
        recvs = [((x.shape[0], m, *x.shape[2:]), k) for k, m in take]
        got = _exchange(sends, recvs, x)
        above = sum(1 for k, _ in take if k < s)
        return torch.cat([*got[:above], x, *got[above:]], dim=1)

    @staticmethod
    def backward(ctx, g):
        give, take, rows = ctx.plan
        s = spatial_rank()
        sends, at, passed = [], 0, False
        for k, m in take:
            if k > s and not passed:
                at, passed = at + rows, True
            sends.append((g[:, at:at + m], k))
            at += m
        t = sum(m for k, m in take if k < s)
        recvs = [((g.shape[0], m, *g.shape[2:]), j) for j, _, m in give]
        got = _exchange(sends, recvs, g)
        dx = g[:, t:t + rows].clone()
        for (_, a, m), d in zip(give, got):
            dx[:, a:a + m] += d
        return dx, None, None


def halo(x: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
    """x (N, H, ...) with `top` rows of the bands above before it and
    `bottom` rows of the bands below after it, gathered from as many bands
    as they span and none past the image's global top and bottom
    (`halo_rows` says how many arrive; x itself without spatial
    sharding); gradients go back to their bands."""
    if not _banded() or not (top or bottom):
        return x
    if min(top, bottom) < 0:
        raise ValueError(f"a halo of {top}, {bottom} rows")
    split = band_split(x.shape[1])
    return _Halo.apply(x, split, _windows(split, top, bottom))


def halo_window(x: torch.Tensor, split: tuple[int, ...],
                windows: tuple) -> torch.Tensor:
    """x, this rank's band of `split` (each band's rows at x's level),
    with the rows of its window `windows[rank]` (global [first, end)
    rows, its band within) from the bands they lie on; `windows` holds
    every band's, the same on every rank (a resize between two splits
    that are not proportional reads past each band by its own amount)."""
    s = spatial_rank()
    start = sum(split[:s])
    a, b = windows[s]
    if a > start or b < start + split[s] or x.shape[1] != split[s]:
        raise ValueError(f"a window {windows[s]} of a band of rows "
                         f"[{start}, {start + x.shape[1]})")
    return _Halo.apply(x, tuple(split), tuple(windows))


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
    not start on the global grid. Without spatial sharding, and within
    `replicated()`, `fn(x)`."""
    if not _banded():
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
