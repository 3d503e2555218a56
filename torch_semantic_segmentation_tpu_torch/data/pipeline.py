"""Host → card input pipeline of the port (the JAX package's
`data/pipeline.py`): host threads decode uint8 batches, `prefetch_to_device`
copies them to the card ahead of the step from pinned memory on a side CUDA
stream, and `augment_batch` turns each uint8 batch into the normalised crop
on the card, so only uint8 crosses PCIe (8x1024x2048x3 uint8 is 48 MiB
against 192 MiB of float32).

`epoch_order` and `batch_iterator` give the JAX package's batches for a
seed, byte for byte. The augmentation's random stream is the generator's
(Philox on the card, threefry in JAX), drawn once a batch in order, so a
generator restored from a checkpoint goes on with the same draws.
"""

from __future__ import annotations

import collections
import queue
import threading
import typing as tp

import numpy as np
import torch

from torch_semantic_segmentation_tpu_torch.device import resolve_device


def epoch_order(n: int, epoch: int, *, seed: int = 0,
                shuffle: bool = True) -> np.ndarray:
    """Deterministic per-epoch sample order: a fresh permutation seeded by
    (seed, epoch), so any point of the stream is reconstructable from the
    (seed, batch-sequence-number) pair alone — the contract resume relies
    on."""
    if not shuffle:
        return np.arange(n)
    return np.random.default_rng((seed, epoch)).permutation(n)


def batch_iterator(
    dataset,            # indexable -> (image u8 HWC, label u8 HW)
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = True,
    num_threads: int = 4,
    epochs: int | None = None,
    label_lut: np.ndarray | None = None,
    start_batch: int = 0,
    sample_slice: tuple[int, int] | None = None,
) -> tp.Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield (images (B,H,W,3) uint8, labels (B,H,W) uint8) host batches,
    decoded by a thread pool that runs ahead of the consumer.

    Deterministic: batch k of a (dataset, batch_size, seed) stream is always
    the same, independent of num_threads — workers decode concurrently but a
    reorder buffer publishes strictly by sequence number. `start_batch`
    fast-forwards to batch k without decoding the skipped ones (resume:
    checkpointed step == batches consumed). `sample_slice=(lo, hi)` decodes
    only that slice of each batch's sample list (one process's share of a
    global batch)."""
    n = len(dataset)
    if n == 0:
        raise ValueError("empty dataset")
    if drop_last:
        batches_per_epoch = n // batch_size
    else:
        batches_per_epoch = -(-n // batch_size)
    if batches_per_epoch == 0:
        raise ValueError(f"dataset ({n}) smaller than batch ({batch_size}) "
                         "with drop_last")
    end = None if epochs is None else epochs * batches_per_epoch

    work: "queue.Queue[tuple[int, list[int]] | None]" = queue.Queue(maxsize=4)
    done: "queue.Queue" = queue.Queue(maxsize=max(4, num_threads + 2))

    def producer():
        order, order_epoch = None, -1
        seq = start_batch
        while end is None or seq < end:
            epoch, b = divmod(seq, batches_per_epoch)
            if epoch != order_epoch:
                order = epoch_order(n, epoch, seed=seed, shuffle=shuffle)
                order_epoch = epoch
            i = b * batch_size
            work.put((seq, list(order[i:i + batch_size])))
            seq += 1
        for _ in range(num_threads):
            work.put(None)

    def worker():
        while True:
            item = work.get()
            if item is None:
                done.put(None)
                return
            seq, idxs = item
            if sample_slice is not None:
                idxs = idxs[sample_slice[0]:sample_slice[1]]
            imgs, lbls = [], []
            for j in idxs:
                im, lb = dataset[j]
                if label_lut is not None:
                    lb = label_lut[lb]
                imgs.append(im)
                lbls.append(lb)
            done.put((seq, (np.stack(imgs), np.stack(lbls))))

    threading.Thread(target=producer, daemon=True).start()
    for _ in range(num_threads):
        threading.Thread(target=worker, daemon=True).start()

    # reorder buffer: workers finish out of order; publish strictly by seq
    pending: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    next_seq = start_batch
    finished = 0
    while finished < num_threads:
        while next_seq in pending:
            yield pending.pop(next_seq)
            next_seq += 1
        item = done.get()
        if item is None:
            finished += 1
            continue
        seq, batch = item
        pending[seq] = batch
    while next_seq in pending:
        yield pending.pop(next_seq)
        next_seq += 1


class _PinnedSlot:
    """One host buffer of the prefetch ring: page-locked tensors of one
    batch's shapes, and the event of the last copy that read them."""

    def __init__(self):
        self.host: tuple[torch.Tensor, ...] = ()
        self.copied: torch.cuda.Event | None = None

    def buffers(self, shapes, dtypes) -> tuple[torch.Tensor, ...]:
        """The slot's tensors, after the last copy from them has completed;
        (re)allocated where the batch's shapes changed."""
        if self.copied is not None:
            self.copied.synchronize()
            self.copied = None
        if [(tuple(t.shape), t.dtype) for t in self.host] != list(
                zip(shapes, dtypes)):
            self.host = tuple(torch.empty(s, dtype=d, pin_memory=True)
                              for s, d in zip(shapes, dtypes))
        return self.host


def _as_tensors(item) -> tuple[torch.Tensor, ...]:
    """A host batch (an array, or a tuple of arrays) as a tuple of
    tensors."""
    if isinstance(item, (np.ndarray, torch.Tensor)):
        item = (item,)
    return tuple(torch.as_tensor(a) for a in item)


def prefetch_to_device(iterator: tp.Iterator, *, size: int = 2,
                       device: str | torch.device | None = None
                       ) -> tp.Iterator[tuple[torch.Tensor, ...]]:
    """Keep `size` batches in flight to `device` (the card unless the
    caller passes "cpu"): each host batch (an array or a tuple of arrays)
    is copied to the card while the consumer works on an earlier one, and
    yielded as a tuple of tensors.

    On the card it keeps a ring of `size + 1` pinned host buffers and one
    side CUDA stream. A batch is written into the next pinned slot (by
    `NativeBatchLoader` itself, else by one host copy), then copied on the
    side stream with `non_blocking=True`, and an event is recorded after
    the copy. Before the batch is yielded, the consumer's stream waits on
    that event and the device tensors are `record_stream`'d to it, so the
    caching allocator does not hand their memory to the side stream while
    the consumer still reads them. A slot is refilled only after the event
    of its last copy has completed. On the CPU the batches pass through as
    tensors, unpinned (pinning needs CUDA)."""
    from torch_semantic_segmentation_tpu_torch.data.native_loader import (
        NativeBatchLoader)

    if size < 1:
        raise ValueError(f"prefetch size {size}; it must be at least 1")
    dev = resolve_device(device)
    if dev.type != "cuda":
        for item in iterator:
            yield tuple(t.to(dev) for t in _as_tensors(item))
        return

    stream = torch.cuda.Stream(device=dev)
    slots = [_PinnedSlot() for _ in range(size + 1)]
    in_flight: collections.deque = collections.deque()
    writes_into = isinstance(iterator, NativeBatchLoader)

    def fill(slot: _PinnedSlot):
        """The next host batch in `slot`'s pinned buffers, or None."""
        if writes_into:
            host = slot.buffers(iterator.batch_shapes,
                                [torch.uint8] * len(iterator.batch_shapes))
            try:
                iterator.__next__(out=host)
            except StopIteration:
                return None
            return host
        try:
            item = _as_tensors(next(iterator))
        except StopIteration:
            return None
        host = slot.buffers([t.shape for t in item], [t.dtype for t in item])
        for h, t in zip(host, item):
            h.copy_(t)
        return host

    def ready(batch, event):
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(event)
        for t in batch:
            t.record_stream(consumer)
        return batch

    k = 0
    while True:
        slot = slots[k % len(slots)]
        host = fill(slot)
        if host is None:
            break
        with torch.cuda.stream(stream):
            batch = tuple(h.to(dev, non_blocking=True) for h in host)
            event = torch.cuda.Event()
            event.record(stream)
        slot.copied = event
        in_flight.append((batch, event))
        k += 1
        if len(in_flight) > size:
            yield ready(*in_flight.popleft())
    while in_flight:
        yield ready(*in_flight.popleft())


def train_input_pipeline(
    dataset,
    batch_size: int,
    augment_cfg,
    *,
    generator: torch.Generator,
    label_lut: np.ndarray | None = None,
    device: str | torch.device | None = None,
    prefetch: int = 2,
    native: bool = False,
    **loader_kwargs,
) -> tp.Iterator[tuple[torch.Tensor, torch.Tensor]]:
    """Full train pipeline: host decode → prefetch to the card → fused
    augmentation on the card. Yields `augment_batch(images, labels,
    generator, augment_cfg)` (normalised images, int32 labels) for each
    batch, drawing from `generator` (on `device`) once a batch, in order.

    `native=True` decodes by `native_loader.native_batch_iterator` over the
    dataset's paths (a build failure raises), else by `batch_iterator` over
    the dataset's `__getitem__`; `loader_kwargs` go to the loader
    (`seed`, `shuffle`, `num_threads`, `start_batch`, ...).

    Under a process group `batch_size` is the global batch, and the rank
    decodes and augments its rows of each (`sample_slice` from
    `distributed.local_shard_range`)."""
    from torch_semantic_segmentation_tpu_torch.data.transforms import (
        augment_batch)
    from torch_semantic_segmentation_tpu_torch.parallel import distributed

    if distributed.is_initialized():
        loader_kwargs.setdefault("sample_slice",
                                 distributed.local_shard_range(batch_size))

    if native:
        from torch_semantic_segmentation_tpu_torch.data.native_loader import (
            native_batch_iterator)
        host = native_batch_iterator(dataset, batch_size, label_lut=label_lut,
                                     **loader_kwargs)
    else:
        host = batch_iterator(dataset, batch_size, label_lut=label_lut,
                              **loader_kwargs)
    for images, labels in prefetch_to_device(host, size=prefetch,
                                             device=device):
        yield augment_batch(images, labels, generator, augment_cfg)
