"""Carry weights into the PyTorch port: from the JAX package, and from
torch `.pth` / `.pt` files.

The JAX package's `compat.export_torch_state_dict(model)` returns numpy
arrays already in torch layout (conv weights OIHW; BatchNorm weight, bias,
running_mean, running_var), keyed by module path. The port keeps the JAX
package's attribute paths, so the keys are the port's state-dict keys; only
BatchNorm's `num_batches_tracked` counter, which the JAX package does not
keep, has to be added.

A torch checkpoint (the reference's pretrained format, what
`export_torch_state_dict` writes once saved) is in the port's layout too, so
importing it is a key map and a strict `load_state_dict`
(`load_torch_checkpoint`); where its names differ, `compat.key_maps` aligns
them by order and shape.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch
from torch import nn


def state_dict_from_jax(arrays: tp.Mapping[str, np.ndarray]
                        ) -> dict[str, torch.Tensor]:
    """A state dict that the port's model loads with `strict=True`."""
    sd = {k: torch.from_numpy(np.array(v, copy=True)) for k, v in arrays.items()}
    for key in list(sd):
        if key.endswith(".running_mean"):
            prefix = key[: -len("running_mean")]
            sd[prefix + "num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def _is_counter_key(key: str) -> bool:
    return key.endswith("num_batches_tracked")


def import_state_dict(model: nn.Module,
                      state_dict: tp.Mapping[str, tp.Any], *,
                      key_map: tp.Callable[[str], str] | None = None,
                      strict: bool = True) -> list[str]:
    """Load a torch-layout state dict (tensors or numpy arrays) into
    `model` in place. `key_map` rewrites each of the model's keys before
    lookup. Returns the checkpoint keys that were not consumed.

    With `strict=True`, raises KeyError if a model key has no match or a
    checkpoint key (other than `num_batches_tracked`) is left over; a shape
    mismatch raises ValueError. A BatchNorm counter the file lacks is set
    to 0; without `strict`, a missing tensor keeps the model's value."""
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    target = model.state_dict()
    used: set[str] = set()
    missing: list[str] = []
    new: dict[str, torch.Tensor] = {}
    for name, current in target.items():
        key = key_map(name) if key_map is not None else name
        if key not in sd:
            if _is_counter_key(name):
                new[name] = torch.zeros_like(current)
            else:
                missing.append(key)
                new[name] = current
            continue
        value = sd[key]
        if tuple(value.shape) != tuple(current.shape):
            raise ValueError(
                f"shape mismatch for '{key}': checkpoint "
                f"{tuple(value.shape)} vs model {tuple(current.shape)}")
        new[name] = value.to(current.dtype)
        used.add(key)
    leftover = [k for k in sd if k not in used and not _is_counter_key(k)]
    if strict and (missing or leftover):
        raise KeyError(
            f"state_dict mismatch; missing={missing[:8]}"
            f"{'...' if len(missing) > 8 else ''} "
            f"leftover={leftover[:8]}{'...' if len(leftover) > 8 else ''}")
    model.load_state_dict(new, strict=True)
    return leftover


def load_torch_checkpoint(model: nn.Module, path: str, *,
                          auto_map: bool = False, strict: bool = True,
                          key_map: tp.Callable[[str], str] | None = None
                          ) -> list[str]:
    """Load a `.pth`/`.pt` file saved by torch into `model` (a bare state
    dict, or one under `"state_dict"`); returns the keys left over.

    `auto_map=True` tolerates arbitrarily renamed keys by structural
    order + shape alignment (`compat.key_maps.load_with_auto_map`), with
    DDP `module.` prefixes stripped first."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if auto_map:
        from torch_semantic_segmentation_tpu_torch.compat.key_maps import (
            load_with_auto_map)
        return load_with_auto_map(model, sd, strict=strict)
    return import_state_dict(model, sd, key_map=key_map, strict=strict)
