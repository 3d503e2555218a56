"""Carry weights from the JAX package into the PyTorch port.

The JAX package's `compat.export_torch_state_dict(model)` returns numpy
arrays already in torch layout (conv weights OIHW; BatchNorm weight, bias,
running_mean, running_var), keyed by module path. The port keeps the JAX
package's attribute paths, so the keys are the port's state-dict keys; only
BatchNorm's `num_batches_tracked` counter, which the JAX package does not
keep, has to be added.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch


def state_dict_from_jax(arrays: tp.Mapping[str, np.ndarray]
                        ) -> dict[str, torch.Tensor]:
    """A state dict that the port's model loads with `strict=True`."""
    sd = {k: torch.from_numpy(np.array(v, copy=True)) for k, v in arrays.items()}
    for key in list(sd):
        if key.endswith(".running_mean"):
            prefix = key[: -len("running_mean")]
            sd[prefix + "num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd
