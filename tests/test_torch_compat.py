"""PyTorch port, weight import (`compat/key_maps.py`,
`compat/torch_loader.load_torch_checkpoint`, `models.get_model(pretrained=)`)
against the JAX package on the CPU:

- FastSCNN, ENet and UNet: the port's `auto_key_map` equals the JAX
  package's on the same renamed state dict (opaque names, `nn.Sequential`
  integer paths, a DDP `module.` prefix), and `load_with_auto_map` loads
  every tensor (the other ten zoo models: `test_torch_compat_zoo.py`);
- a wrong architecture raises in both packages, and a same-shape swap
  warns in both;
- `get_model(name, pretrained=...)` on a `.pth` written from the JAX
  package's `export_torch_state_dict` (a directory, a file, `.pt`, a
  renamed dict under "state_dict") gives eval logits equal to the JAX
  model's at rtol = atol = 1e-4, the bar of `tests/test_compat.py:217`;
- `alias_key_map` and `strip_state_dict_prefixes` as in the JAX package."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_semantic_segmentation_tpu.compat import key_maps as jkey_maps
from torch_semantic_segmentation_tpu.compat.torch_loader import (
    export_torch_state_dict)
from torch_semantic_segmentation_tpu_torch.compat import (
    MODEL_KEY_ALIASES, alias_key_map, auto_key_map, import_state_dict,
    load_torch_checkpoint, state_dict_from_jax, strip_state_dict_prefixes)
from torch_semantic_segmentation_tpu_torch.compat import key_maps
from torch_semantic_segmentation_tpu_torch.models import get_model

from torch_port_util import (
    ZOO_TEST_KWARGS, auto_map_matches_jax, jax_zoo_model, randomize_bn,
    renamed_state_dicts)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _plain_jax_path(monkeypatch):
    monkeypatch.setenv("TPU_SEG_PACKED_ENET", "0")
    monkeypatch.setenv("TPU_SEG_PACKED_ENET_BODY", "0")


@pytest.mark.parametrize("name", ["fastscnn", "enet", "unet"])
def test_auto_key_map_equals_jax(name):
    auto_map_matches_jax(name)


def test_renamings_keep_order_and_values():
    sd = {"a.b.weight": 1, "a.b.bias": 2, "a.c.weight": 3, "d.weight": 4}
    r = renamed_state_dicts(sd)
    assert list(r["sequential"]) == ["features.0.0.weight",
                                     "features.0.0.bias",
                                     "features.0.1.weight",
                                     "features.1.weight"]
    assert [list(v.values()) for v in r.values()] == [[1, 2, 3, 4]] * 3


def _fastscnn_pair(num_classes=5):
    j = jax_zoo_model("fastscnn", num_classes)
    return j, get_model("fastscnn", num_classes, device="cpu")


def test_wrong_architecture_raises_in_both_packages():
    j, t = _fastscnn_pair()
    sd = state_dict_from_jax(export_torch_state_dict(j))
    dropped = dict(sd)
    dropped.pop("classifier.conv.bias")
    seven = state_dict_from_jax(export_torch_state_dict(
        jax_zoo_model("fastscnn", 7)))
    for bad, match in ((dropped, "count mismatch"),
                       (seven, "shape mismatch at position")):
        with pytest.raises(ValueError, match=match):
            jkey_maps.auto_key_map(j, bad)
        with pytest.raises(ValueError, match=match):
            auto_key_map(t, bad)
    enet = state_dict_from_jax(export_torch_state_dict(
        jax_zoo_model("enet", 5)))
    for package in (jkey_maps.auto_key_map, auto_key_map):
        with pytest.raises(ValueError, match="count mismatch"):
            package(j if package is jkey_maps.auto_key_map else t, enet)
    with pytest.raises(KeyError, match="state_dict mismatch"):
        import_state_dict(t, dropped)
    with pytest.raises(ValueError, match="shape mismatch for"):
        import_state_dict(t, seven)


def test_same_shape_swap_warns_in_both_packages():
    j, t = _fastscnn_pair()
    items = list(state_dict_from_jax(export_torch_state_dict(j)).items())
    keys = [k for k, _ in items]
    a, b = keys.index("lds.conv.bn.weight"), keys.index("lds.conv.bn.bias")
    items[a], items[b] = items[b], items[a]
    for package, model in ((jkey_maps.auto_key_map, j), (auto_key_map, t)):
        with pytest.warns(UserWarning, match="different position"):
            package(model, dict(items))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        auto_key_map(t, dict(state_dict_from_jax(export_torch_state_dict(j))))


def test_a_module_with_tensors_and_children_is_refused():
    m = torch.nn.Module()
    m.weight = torch.nn.Parameter(torch.zeros(2))
    m.child = torch.nn.Linear(2, 2)
    with pytest.raises(ValueError, match="holds its own tensors"):
        key_maps._model_param_sequence(m)


@pytest.mark.parametrize("name", ["fastscnn", "enet", "unet"])
def test_get_model_pretrained_gives_jax_logits(tmp_path, name):
    kw = ZOO_TEST_KWARGS.get(name, {})
    j = jax_zoo_model(name, 5, seed=3, **kw)
    x = np.random.default_rng(5).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    randomize_bn(j, np.random.default_rng(6))
    j.eval()
    want = np.asarray(j(jnp.asarray(x)))
    arrays = export_torch_state_dict(j)
    plain = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    torch.save(plain, tmp_path / f"{name}.pth")
    (tmp_path / "pt").mkdir()
    torch.save(plain, tmp_path / "pt" / f"{name}.pt")
    renamed = renamed_state_dicts(plain)["sequential"]
    torch.save({"state_dict": renamed, "epoch": 3}, tmp_path / "renamed.pth")
    for source in (tmp_path, tmp_path / f"{name}.pth", tmp_path / "pt",
                   tmp_path / "renamed.pth"):
        model = get_model(name, 5, pretrained=str(source), seed=9,
                          device="cpu", **kw).eval()
        with torch.no_grad():
            got = model(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        for key, value in model.state_dict().items():
            if key.endswith("num_batches_tracked"):
                assert int(value) == 0
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match=f"no {name}.pth"):
        get_model(name, 5, pretrained=str(tmp_path / "empty"), device="cpu",
                  **kw)


def test_load_torch_checkpoint_strict_and_key_map(tmp_path):
    j, t = _fastscnn_pair()
    randomize_bn(j, np.random.default_rng(2))
    sd = {k: torch.from_numpy(v.copy())
          for k, v in export_torch_state_dict(j).items()}
    table = {"lds": "learning_to_downsample", "gfe": "global_feature"}
    renamed = {".".join(table.get(s, s) for s in k.split(".")): v
               for k, v in sd.items()}
    torch.save(renamed, tmp_path / "renamed.pth")
    with pytest.raises(KeyError, match="state_dict mismatch"):
        load_torch_checkpoint(t, str(tmp_path / "renamed.pth"))
    assert load_torch_checkpoint(t, str(tmp_path / "renamed.pth"),
                                 key_map=alias_key_map(table)) == []
    for k, v in sd.items():
        assert torch.equal(t.state_dict()[k], v)
    extra = dict(sd, stray=torch.zeros(1))
    torch.save(extra, tmp_path / "extra.pth")
    assert load_torch_checkpoint(get_model("fastscnn", 5, device="cpu"),
                                 str(tmp_path / "extra.pth"),
                                 strict=False) == ["stray"]
    with pytest.raises(KeyError, match="leftover=\\['stray'\\]"):
        load_torch_checkpoint(t, str(tmp_path / "extra.pth"))


def test_alias_tables_and_prefix_strip_equal_jax():
    assert MODEL_KEY_ALIASES == jkey_maps.MODEL_KEY_ALIASES
    keys = ["module.initial.conv.weight", "stage1.skip.bn.bias",
            "initial_x.weight", "head.0.weight"]
    for table in MODEL_KEY_ALIASES.values():
        port, ref = alias_key_map(table), jkey_maps.alias_key_map(table)
        assert [port(k) for k in keys] == [ref(k) for k in keys]
    sd = {"module.a": 1, "model.b": 2, "c": 3}
    for prefixes in (("module.",), ("module.", "model.")):
        assert strip_state_dict_prefixes(sd, prefixes) == (
            jkey_maps.strip_state_dict_prefixes(sd, prefixes))
