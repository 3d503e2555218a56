"""PyTorch port, `compat.key_maps.auto_key_map` against the JAX package's
for the ten zoo models `tests/test_torch_compat.py` does not take, at test
size (BiSeNet and ICNet at depth 18): each under three renamings of its
state dict that keep the order (opaque names, `nn.Sequential` integer
paths, a DDP `module.` prefix), equal maps, the port's walk equal to the
JAX walk, and every tensor loaded by `load_with_auto_map`."""

import pytest
import torch

from torch_port_util import auto_map_matches_jax

torch.set_num_threads(2)


@pytest.mark.parametrize("name", [
    "deeplabv3_resnet18", "deeplabv3_resnet34", "deeplabv3_resnet50",
    "deeplabv3_resnet101", "bisenet", "icnet", "contextnet", "erfnet",
    "esnet", "lednet"])
def test_auto_key_map_equals_jax(name):
    auto_map_matches_jax(name)
