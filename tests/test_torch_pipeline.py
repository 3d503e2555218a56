"""PyTorch port, the input pipeline (`data/pipeline.py`) against the JAX
package's on the CPU:

- `epoch_order` equal to JAX's;
- `batch_iterator` equal to JAX's batch for batch on the same dataset, for
  two seeds and 1 and 4 threads, with `start_batch`, `sample_slice`, a LUT
  and `drop_last=False`, across epoch reshuffles;
- `prefetch_to_device(device="cpu")` yields every batch in order, as
  tensors; without a device it needs the card;
- `train_input_pipeline` yields `augment_batch` of batch k drawn from the
  generator's k-th state, on both loaders' streams."""

import numpy as np
import pytest
import torch

from torch_semantic_segmentation_tpu.data import pipeline as jpipeline
from torch_semantic_segmentation_tpu_torch.data import pipeline
from torch_semantic_segmentation_tpu_torch.data.synthetic import ShapesDataset
from torch_semantic_segmentation_tpu_torch.data.transforms import (
    AugmentConfig, augment_batch)

torch.set_num_threads(2)

LUT = np.full((256,), 255, np.uint8)
LUT[:4] = [0, 11, 13, 255]


@pytest.mark.parametrize("n", [1, 7, 24])
@pytest.mark.parametrize("seed", [0, 5])
def test_epoch_order_equals_jax(n, seed):
    for epoch in range(3):
        for shuffle in (True, False):
            np.testing.assert_array_equal(
                pipeline.epoch_order(n, epoch, seed=seed, shuffle=shuffle),
                jpipeline.epoch_order(n, epoch, seed=seed, shuffle=shuffle))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("num_threads", [1, 4])
@pytest.mark.parametrize("kw", [
    dict(),
    dict(start_batch=3),
    dict(sample_slice=(2, 6), label_lut=LUT),
    dict(drop_last=False, label_lut=LUT, start_batch=1),
    dict(shuffle=False),
], ids=["plain", "start_batch", "slice_lut", "no_drop_last", "no_shuffle"])
def test_batch_iterator_equals_jax(seed, num_threads, kw):
    ds = ShapesDataset(11, 16, 24, seed=seed)
    port = list(pipeline.batch_iterator(ds, 4 if "sample_slice" not in kw
                                        else 6, seed=seed, epochs=3,
                                        num_threads=num_threads, **kw))
    ref = list(jpipeline.batch_iterator(ds, 4 if "sample_slice" not in kw
                                        else 6, seed=seed, epochs=3,
                                        num_threads=num_threads, **kw))
    assert len(port) == len(ref) > 0
    for (pi, pl), (ri, rl) in zip(port, ref):
        assert pi.dtype == ri.dtype and pl.dtype == rl.dtype
        np.testing.assert_array_equal(pi, ri)
        np.testing.assert_array_equal(pl, rl)


def test_batch_iterator_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="empty"):
        next(pipeline.batch_iterator(ShapesDataset(0), 2))
    with pytest.raises(ValueError, match="smaller than batch"):
        next(pipeline.batch_iterator(ShapesDataset(3), 4))


def test_prefetch_to_cpu_yields_all_batches_in_order():
    ds = ShapesDataset(9, 16, 24, seed=1)
    host = list(pipeline.batch_iterator(ds, 2, epochs=1, num_threads=2))
    for size in (1, 2, 3):
        got = list(pipeline.prefetch_to_device(iter(host), size=size,
                                               device="cpu"))
        assert len(got) == len(host) == 4
        for (gi, gl), (hi, hl) in zip(got, host):
            assert isinstance(gi, torch.Tensor) and gi.device.type == "cpu"
            assert not gi.is_pinned()
            np.testing.assert_array_equal(gi.numpy(), hi)
            np.testing.assert_array_equal(gl.numpy(), hl)
    (only,) = pipeline.prefetch_to_device(iter([host[0][0]]), device="cpu")
    np.testing.assert_array_equal(only[0].numpy(), host[0][0])
    with pytest.raises(ValueError, match="at least 1"):
        next(pipeline.prefetch_to_device(iter(host), size=0, device="cpu"))


@pytest.mark.skipif(torch.cuda.is_available(), reason="a host without a card")
def test_prefetch_without_a_device_needs_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(pipeline.prefetch_to_device(iter([np.zeros(3)])))


def test_train_input_pipeline_draws_the_generators_kth_state():
    ds = ShapesDataset(10, 32, 48, seed=2)
    cfg = AugmentConfig(crop=(24, 40))
    gen = torch.Generator().manual_seed(11)
    got = list(pipeline.train_input_pipeline(
        ds, 3, cfg, generator=gen, label_lut=LUT, device="cpu", seed=4,
        epochs=2, num_threads=2))
    host = list(pipeline.batch_iterator(ds, 3, label_lut=LUT, seed=4,
                                        epochs=2, num_threads=1))
    assert len(got) == len(host) == 6
    ref = torch.Generator().manual_seed(11)
    for (images, labels), (hi, hl) in zip(got, host):
        want = augment_batch(torch.from_numpy(hi), torch.from_numpy(hl), ref,
                             cfg)
        assert images.shape == (3, 24, 40, 3) and labels.dtype == torch.int32
        assert torch.equal(images, want[0]) and torch.equal(labels, want[1])
    assert torch.equal(gen.get_state(), ref.get_state())
