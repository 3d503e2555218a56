"""Helpers for the tests that hold the PyTorch port against the JAX package."""

import jax.numpy as jnp
import numpy as np
from flax import nnx

from torch_semantic_segmentation_tpu.compat.torch_loader import (
    export_torch_state_dict)
from torch_semantic_segmentation_tpu_torch.compat import state_dict_from_jax


def randomize_bn(jmodule, rng: np.random.Generator):
    """Random running stats and affine params on every JAX BatchNorm, so
    that eval mode and folding are not the identity."""
    for _, m in nnx.iter_graph(jmodule):
        if isinstance(m, nnx.BatchNorm):
            m.mean[...] = jnp.asarray(
                rng.normal(0, 0.5, m.mean.shape).astype(np.float32))
            m.var[...] = jnp.asarray(
                rng.uniform(0.5, 2.0, m.var.shape).astype(np.float32))
            m.scale[...] = jnp.asarray(
                rng.uniform(0.5, 1.5, m.scale.shape).astype(np.float32))
            m.bias[...] = jnp.asarray(
                rng.normal(0, 0.2, m.bias.shape).astype(np.float32))


def carry_weights(jmodule, tmodule, seed: int = 0):
    """Random BN stats on the JAX module, both modules in eval mode, and
    the JAX weights loaded into the port's module with strict=True."""
    randomize_bn(jmodule, np.random.default_rng(seed))
    jmodule.eval()
    tmodule.load_state_dict(
        state_dict_from_jax(export_torch_state_dict(jmodule)), strict=True)
    return tmodule.eval()
