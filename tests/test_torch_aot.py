"""PyTorch port, `serving.aot_compile` and the predictor's weights on the
CPU against the JAX package, the JAX weights carried by
`tests/torch_port_util.carry_weights` (random BN statistics, strict
load), the JAX package on its plain paths:

- FastSCNN (`upsample_logits=False`: K5's plain version on the folded
  pairs), UNet with the bilinear decoder (K4's plain version) and ENet
  (JAX's own `test_aot_compile_executes` model): the port's compiled
  predictor against JAX's `aot_compile` on seeded frames, logits at
  rtol = atol = 1e-4 and ids mismatching below 1e-3 (the bars of
  tests/test_torch_serving.py), and equal to the port's own eager
  predictor bit for bit;
- a shape or dtype the predictor was not compiled for raises TypeError in
  both packages, a batch that is not padded too;
- each call returns a fresh tensor;
- both packages' predictors, eager and compiled, serve the weights of
  build time: halving every parameter of the model afterwards moves their
  outputs by 0.0;
- `cli.predict.predict_frames` over two resolutions gives the ids of the
  eager predictor in padded batches;
- `aot_compile` refuses spatial sharding, NaN debugging and a callable that
  did not come from `make_predict_fn`.

The CUDA graph itself (ids bit for bit against the eager predictor, no
overwrite, the kernels' launches held in a capture) runs in
tests/test_torch_cuda.py on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from torch_semantic_segmentation_tpu.serving import (
    aot_compile as j_aot_compile)
from torch_semantic_segmentation_tpu.serving import (
    make_predict_fn as j_make_predict_fn)
from torch_semantic_segmentation_tpu_torch import debug, kernels
from torch_semantic_segmentation_tpu_torch.cli.predict import predict_frames
from torch_semantic_segmentation_tpu_torch.models import get_model
from torch_semantic_segmentation_tpu_torch.parallel import distributed
from torch_semantic_segmentation_tpu_torch.serving import (
    CompiledPredictor, aot_compile, make_predict_fn)

from torch_port_util import carry_weights, jax_zoo_model

torch.set_num_threads(2)

C = 5
# (batch, H, W) of each model's frames: FastSCNN takes multiples of 32,
# UNet of 16, ENet of 8
SHAPES = {"fastscnn": (2, 64, 96), "unet": (2, 32, 48), "enet": (2, 32, 48)}


@pytest.fixture(autouse=True)
def plain_jax_paths(monkeypatch):
    for flag in ("TPU_SEG_PACKED_ENET", "TPU_SEG_PACKED_ENET_BODY",
                 "TPU_SEG_PACKED_UNET_BODY"):
        monkeypatch.setenv(flag, "0")


KWARGS = {"fastscnn": {"upsample_logits": False},
          "unet": {"base_ch": 4, "upsample": "bilinear"}, "enet": {}}


def _models(name: str, classes: int = C):
    j = jax_zoo_model(name, classes, **KWARGS[name])
    t = get_model(name, classes, device="cpu", **KWARGS[name])
    return j, carry_weights(j, t, seed=1)


def _frames(shape, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (*shape, 3),
                                                np.uint8)


@pytest.mark.parametrize("output", ["logits", "ids"])
@pytest.mark.parametrize("name", ["fastscnn", "unet", "enet"])
def test_compiled_predictor_matches_jax(name, output):
    j, t = _models(name)
    frames = _frames(SHAPES[name])
    want = np.asarray(j_aot_compile(j_make_predict_fn(j, output=output),
                                    *SHAPES[name])(jnp.asarray(frames)))
    predict = make_predict_fn(t, output=output, device="cpu")
    compiled = aot_compile(predict, *SHAPES[name])
    got = compiled(frames)
    assert isinstance(compiled, CompiledPredictor)
    assert compiled.graph is None and compiled.held == {}
    assert got.device.type == "cpu" and got.shape == want.shape
    assert torch.equal(got, predict(frames))
    if name == "fastscnn":
        # the folded pairs run K5's plain version
        assert all(blk.bn is None for blk in (
            predict.model.classifier.ds1.dw, predict.model.ffm.dwconv))
    if output == "logits":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    else:
        assert got.dtype == torch.uint8
        assert (got.numpy() != want).mean() < 1e-3


def test_wrong_shape_or_dtype_raises_type_error_in_both_packages():
    j, t = _models("enet", 4)
    j_compiled = j_aot_compile(j_make_predict_fn(j, output="logits"),
                               2, 16, 16)
    compiled = aot_compile(make_predict_fn(t, output="logits", device="cpu"),
                           2, 16, 16)
    good = np.zeros((2, 16, 16, 3), np.uint8)
    assert tuple(compiled(good).shape) == tuple(j_compiled(good).shape)
    for bad in (np.zeros((2, 16, 16, 3), np.float32),
                np.zeros((2, 16, 16, 3), np.int32),
                np.zeros((1, 16, 16, 3), np.uint8),      # batch not padded
                np.zeros((2, 16, 24, 3), np.uint8)):
        with pytest.raises(TypeError):
            j_compiled(jnp.asarray(bad))
        with pytest.raises(TypeError, match="compiled for uint8 frames"):
            compiled(bad)
        with pytest.raises(TypeError, match="compiled for uint8 frames"):
            compiled(torch.from_numpy(bad))


def test_each_call_returns_a_fresh_tensor():
    _, t = _models("enet", 4)
    compiled = aot_compile(make_predict_fn(t, output="logits", device="cpu"),
                           1, 16, 16)
    f0, f1 = _frames((1, 16, 16), 0), _frames((1, 16, 16), 1)
    a = compiled(f0)
    kept = a.clone()
    b = compiled(f1)
    assert a.data_ptr() != b.data_ptr()
    assert torch.equal(a, kept) and not torch.equal(a, b)
    assert torch.equal(compiled(f0), kept)


def test_predictors_serve_the_weights_of_build_time():
    """ENet(4) on 1x16x16 frames, output="logits": halving every parameter
    of the model after its predictors were built moves neither package's
    eager nor compiled predictor (JAX's serve the `nnx.split` snapshot,
    the port's their own copy of the folded model); a predictor built
    after the halving serves the halved weights."""
    j, t = _models("enet", 4)
    frames = _frames((1, 16, 16))
    j_predict = j_make_predict_fn(j, output="logits")
    j_compiled = j_aot_compile(j_predict, 1, 16, 16)
    predict = make_predict_fn(t, output="logits", device="cpu")
    compiled = aot_compile(predict, 1, 16, 16)
    fns = (lambda: np.asarray(j_predict(jnp.asarray(frames))),
           lambda: np.asarray(j_compiled(jnp.asarray(frames))),
           lambda: predict(frames).numpy(), lambda: compiled(frames).numpy())
    before = [fn() for fn in fns]

    _, params, _ = nnx.split(j, nnx.Param, ...)
    nnx.update(j, jax.tree.map(lambda v: v * 0.5, params))
    with torch.no_grad():
        for p in t.parameters():
            p.mul_(0.5)
    for fn, b in zip(fns, before):
        assert float(np.abs(fn() - b).max()) == 0.0
    # the model itself did change: a predictor built now serves it
    moved = make_predict_fn(t, output="logits", device="cpu")(frames)
    assert float(np.abs(moved.numpy() - before[2]).max()) > 1e-3
    # nor does load_state_dict reach an existing predictor
    t.load_state_dict({k: torch.zeros_like(v)
                       for k, v in t.state_dict().items()})
    assert float(np.abs(compiled(frames).numpy() - before[3]).max()) == 0.0


def test_predict_frames_over_two_resolutions():
    """Each resolution group through one compiled predictor: the ids the
    eager predictor gives on the same padded batches."""
    _, t = _models("fastscnn")
    predict = make_predict_fn(t, output="ids", device="cpu")
    rng = np.random.default_rng(3)
    sizes = [(32, 64)] * 3 + [(64, 32)] * 2
    order = [0, 3, 1, 4, 2]
    frames = [rng.integers(0, 256, (*sizes[i], 3), np.uint8) for i in order]
    got = predict_frames(predict, frames, 2)
    groups: dict = {}
    for i, f in enumerate(frames):
        groups.setdefault(f.shape[:2], []).append(i)
    want = [None] * len(frames)
    for idxs in groups.values():
        for lo in range(0, len(idxs), 2):
            chunk = idxs[lo:lo + 2]
            pad = [chunk[-1]] * (2 - len(chunk))
            out = predict(np.stack([frames[i] for i in chunk + pad]))
            for k, i in enumerate(chunk):
                want[i] = out[k].numpy()
    assert [g.shape for g in got] == [f.shape[:2] for f in frames]
    assert all(g.dtype == np.uint8 and np.array_equal(g, w)
               for g, w in zip(got, want))


def test_aot_compile_refusals(monkeypatch):
    predict = make_predict_fn(get_model("enet", 4, device="cpu"),
                              output="logits", device="cpu")
    with pytest.raises(TypeError, match="make_predict_fn"):
        aot_compile(lambda frames: frames, 1, 16, 16)
    debug.enable_nan_debugging()
    try:
        with pytest.raises(RuntimeError, match="CHECK_FINITE"):
            aot_compile(predict, 1, 16, 16)
    finally:
        debug.enable_nan_debugging(False)
    assert not kernels.CHECK_FINITE
    monkeypatch.setattr(distributed, "num_spatial", lambda: 2)
    with pytest.raises(NotImplementedError, match="spatial sharding"):
        aot_compile(predict, 1, 16, 16)
    monkeypatch.undo()
    assert aot_compile(predict, 1, 16, 16)(
        np.zeros((1, 16, 16, 3), np.uint8)).shape == (1, 16, 16, 4)
