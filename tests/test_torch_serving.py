"""PyTorch port, the serving slice as a whole: the JAX FastSCNN
(upsample_logits=False, eval, random BN stats) → `export_torch_state_dict`
→ `state_dict_from_jax` → the port's FastSCNN on the CPU, through both
packages' `make_predict_fn`. Logits at rtol/atol 1e-4 (the bar
tests/test_compat.py holds the JAX zoo to against torch), ids with a
mismatch below 1e-3."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from torch_semantic_segmentation_tpu.compat.torch_loader import (
    export_torch_state_dict)
from torch_semantic_segmentation_tpu.models.fastscnn import (
    fastscnn as j_fastscnn)
from torch_semantic_segmentation_tpu.serving import (
    make_predict_fn as j_make_predict_fn)
from torch_semantic_segmentation_tpu_torch.compat import state_dict_from_jax
from torch_semantic_segmentation_tpu_torch.models import (
    available_models, fastscnn, get_model)
from torch_semantic_segmentation_tpu_torch.serving import make_predict_fn

from tests.torch_port_util import carry_weights

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).integers(0, 256, (2, 64, 128, 3), np.uint8)


def _pair(upsample_logits=False, aux=False):
    j = j_fastscnn(19, upsample_logits=upsample_logits, aux=aux,
                   rngs=nnx.Rngs(0))
    t = fastscnn(19, upsample_logits=upsample_logits, aux=aux, device="cpu")
    return j, carry_weights(j, t, seed=1)


@pytest.mark.parametrize("output", ["logits", "ids"])
def test_predict_matches_jax(frames, output):
    j, t = _pair()
    want = np.asarray(j_make_predict_fn(j, output=output)(jnp.asarray(frames)))
    predict = make_predict_fn(t, output=output, device="cpu")
    got = predict(frames)
    assert got.device.type == "cpu"
    assert got.shape == want.shape
    # the port's folded model runs K5's plain version on the CPU
    assert all(blk.bn is None for blk in (t.classifier.ds1.dw, t.ffm.dwconv))
    if output == "logits":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    else:
        assert got.dtype == torch.uint8
        assert (got.numpy() != want).mean() < 1e-3


def test_state_dict_keys_equal_jax_paths():
    j = j_fastscnn(19, upsample_logits=False, rngs=nnx.Rngs(0))
    sd = state_dict_from_jax(export_torch_state_dict(j))
    t = fastscnn(19, upsample_logits=False, device="cpu")
    assert set(sd) == set(t.state_dict())
    assert "lds.conv.conv.weight" in sd
    assert "gfe.stage1.0.expand.bn.running_var" in sd
    assert "gfe.ppm.branches.3.conv.weight" in sd
    assert sd["lds.conv.bn.num_batches_tracked"].dtype == torch.long


def test_aux_heads_and_full_res_logits_match_jax():
    j, t = _pair(upsample_logits=True, aux=True)
    x = np.random.default_rng(2).normal(size=(1, 64, 64, 3)).astype(np.float32)
    want = [np.asarray(o) for o in j(jnp.asarray(x))]
    with torch.no_grad():
        got = [o.numpy() for o in t(torch.from_numpy(x))]
    assert [g.shape for g in got] == [(1, 64, 64, 19), (1, 8, 8, 19),
                                      (1, 2, 2, 19)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_probs(frames):
    _, t = _pair()
    p = make_predict_fn(t, output="probs", device="cpu")(frames)
    assert p.shape == (2, 64, 128, 19) and p.dtype == torch.float32
    np.testing.assert_allclose(p.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fastscnn(19)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("fastscnn", 19)
    t = fastscnn(19, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_predict_fn(t)
    with pytest.raises(ValueError, match="output"):
        make_predict_fn(t, output="masks", device="cpu")


def test_model_registry_matches_the_jax_package():
    from torch_semantic_segmentation_tpu.models import (
        available_models as jax_available_models)
    assert available_models() == jax_available_models()
    assert len(available_models()) == 13


def test_model_registry():
    assert available_models() == sorted([
        "fastscnn", "unet", "deeplabv3_resnet18", "deeplabv3_resnet34",
        "deeplabv3_resnet50", "deeplabv3_resnet101", "enet", "bisenet",
        "icnet", "contextnet", "lednet", "erfnet", "esnet"])
    with pytest.raises(KeyError, match="fastscnn"):
        get_model("segformer")
    m = get_model("fastscnn", 5, upsample_logits=False, device="cpu")
    y = m.eval()(torch.zeros(1, 32, 64, 3))
    assert y.shape == (1, 4, 8, 5)
    with pytest.raises(ValueError, match="divisible by 32"):
        m(torch.zeros(1, 30, 64, 3))
