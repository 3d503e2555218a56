"""PyTorch port, spatial sharding on the CPU without ranks: the steps take
only the rank's band of the recorded split.

The JAX package's sharding travels with the array; the port keeps the
split as module state that `parallel.shard_batch` records. A band cut by
other means would read another band's rows from that record (160 rows
recorded as 64/32/32/32 and cut into four bands of 32: band 0 would weigh
its pixels 0.4 and read its halos at the wrong rows), so the train step
(with remat too), the eval step and the multi-scale eval step check the
images' and the labels' H against the record before the model runs
(`distributed.check_band`) and raise ValueError, with no halo and no
collective. On `Bands` (`tests/test_torch_spatial.py`), band s of 4 in
this process. The steps that run do so on `ZeroHaloBands`, whose halo
rows are zeros: those tests hold a step against the same step without the
check, bit for bit, not against the unsharded step (the gloo ranks of
`tests/test_torch_spatial_uneven.py` do that)."""

import numpy as np
import pytest
import torch

from test_torch_spatial import Bands
from torch_semantic_segmentation_tpu_torch import losses
from torch_semantic_segmentation_tpu_torch.eval import (
    make_multiscale_eval_step)
from torch_semantic_segmentation_tpu_torch.models import get_model
from torch_semantic_segmentation_tpu_torch.parallel import distributed
from torch_semantic_segmentation_tpu_torch.train import (
    OptimizerConfig, create_train_state, make_eval_step, make_train_step)

torch.set_num_threads(2)

C = 5
SPLIT = (64, 32, 32, 32)     # split_rows(160, 4, 32)
W = 64


class ZeroHaloBands(Bands):
    """`Bands` whose halo rows of a tensor that is not a band of a global
    one (a feature map inside the model) are zeros, as many as
    `distributed.halo_rows` says arrive: a whole model runs on one band in
    this process. Counts the halos it was asked for, and keeps its bands
    alive, so that no feature map takes a band's id."""

    def __init__(self, n, split=None):
        super().__init__(n, split)
        self.halos = 0
        self._kept = []

    def take(self, x, s):
        band = super().take(x, s)
        self._kept.append(band)
        return band

    def _halo(self, x, top, bottom):
        self.halos += 1
        if id(x) in self._of:
            return super()._halo(x, top, bottom)
        t, b = distributed.halo_rows(top, bottom, x.shape[1])
        return _pad_rows(x, t, b)

    def _halo_window(self, x, split, windows):
        self.halos += 1
        if id(x) in self._of:
            return super()._halo_window(x, split, windows)
        s = distributed.spatial_rank()
        start = sum(split[:s])
        a, b = windows[s]
        return _pad_rows(x, start - a, b - start - x.shape[1])


def _pad_rows(x, top, bottom):
    def zeros(m):
        return x.new_zeros((x.shape[0], m, *x.shape[2:]))
    return torch.cat([zeros(top), x, zeros(bottom)], dim=1)


def _batch(h, seed=0):
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.normal(size=(2, h, W, 3)).astype(
        np.float32))
    labels = torch.from_numpy(rng.integers(0, C, (2, h, W)).astype(
        np.int64))
    return images, labels


def _model():
    torch.manual_seed(0)
    return get_model("fastscnn", C, upsample_logits=False, device="cpu")


def _train_step(model, remat=False):
    return make_train_step(model, create_train_state(model, OptimizerConfig(
        lr=0.01)), losses.resize_cross_entropy_loss, remat=remat,
        device="cpu")


def _steps(model):
    """{name: fn(images, labels)} of the four steps on `model`."""
    train, remat = _train_step(model), _train_step(model, remat=True)
    ev = make_eval_step(model, num_classes=C, device="cpu")
    ms = make_multiscale_eval_step(model, num_classes=C, scales=(1.0,),
                                   device="cpu")
    cm = torch.zeros(C, C, dtype=torch.int64)
    return {"train": train, "remat": remat,
            "eval": lambda x, y: ev(cm, x, y),
            "multiscale": lambda x, y: ms(cm, x, y)}


STEPS = ["train", "remat", "eval", "multiscale"]


@pytest.mark.parametrize("name", STEPS)
def test_step_refuses_a_band_off_the_record(name):
    """Four equal bands of 32 rows of a 160-row image under the record
    64/32/32/32: on band 0 each step raises, naming the band's 32 rows
    and the record's 64, before the model runs, with no halo and no
    collective."""
    model = _model()
    calls = []
    model.register_forward_pre_hook(lambda m, a: calls.append(1))
    step = _steps(model)[name]
    images, labels = _batch(160)
    bands = ZeroHaloBands(4, SPLIT)
    before = distributed.collectives
    with bands.rank(0):
        with pytest.raises(ValueError, match=r"images: band 0 has 32 rows, "
                           r"where the recorded split \(64, 32, 32, 32\) "
                           r"gives it 64"):
            step(images[:, :32], labels[:, :32])
    assert not calls and bands.halos == 0
    assert distributed.collectives == before


@pytest.mark.parametrize("name", STEPS)
def test_step_refuses_labels_off_the_record(name):
    """Band 0's 64 images rows under the record 64/32/32/32, with labels
    of 32 rows: the labels' check raises, naming them."""
    model = _model()
    step = _steps(model)[name]
    images, labels = _batch(160)
    with ZeroHaloBands(4, SPLIT).rank(0):
        with pytest.raises(ValueError, match=r"labels: band 0 has 32 rows, "
                           r"where the recorded split \(64, 32, 32, 32\) "
                           r"gives it 64"):
            step(images[:, :64], labels[:, :32])


def test_check_band_readings():
    """`check_band` passes each band's own rows under the record and any
    rows without one, and within `replicated()`; on band 3 of the record
    it refuses 64 rows, naming 32."""
    with Bands(4, SPLIT).rank(3):
        distributed.check_band(32, "images")
        with distributed.replicated():
            distributed.check_band(64, "images")
        with pytest.raises(ValueError, match="band 3 has 64 rows, where the "
                           "recorded split .* gives it 32"):
            distributed.check_band(64, "images")
    with Bands(4).rank(0):
        distributed.check_band(40, "images")
        distributed.check_band(7, "labels")


def _run_bands(name, split, h, checked):
    """(each band's output, the model's state after the bands) of step
    `name` on the bands of an h-row batch cut as `split` splits it; with
    `checked` False `distributed.check_band` is a no-op (the step as it
    was before the check)."""
    model = _model()
    steps = _steps(model)
    images, labels = _batch(h, seed=3)
    bands = ZeroHaloBands(4, split)
    out = []
    saved = distributed.check_band
    if not checked:
        distributed.check_band = lambda rows, what: None
    try:
        for s in range(4):
            xb = bands.take(images, s)
            yb = labels[:, sum(bands.rows(h)[:s]):][:, :bands.rows(h)[s]]
            with bands.rank(s):
                got = steps[name](xb, yb)
            out.append(got["loss"] if isinstance(got, dict) else got.clone())
    finally:
        distributed.check_band = saved
    assert bands.halos > 0
    return out, {k: v.clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("name", STEPS)
@pytest.mark.parametrize("split,h", [(SPLIT, 160), (None, 128)],
                         ids=["recorded 64-32-32-32", "equal bands"])
def test_bands_of_the_record_run_as_before(name, split, h):
    """Bands cut as the record splits the image (64/32/32/32 of 160 rows)
    and equal bands without a record (4 x 32 of 128) pass the check, and
    each band's loss (or confusion matrix) and the state after the four
    band steps equal those of the same steps without the check, bit for
    bit."""
    got, got_state = _run_bands(name, split, h, checked=True)
    want, want_state = _run_bands(name, split, h, checked=False)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got_state.keys() == want_state.keys()
    for k in want_state:
        assert torch.equal(got_state[k], want_state[k]), k
