"""Weight carry from the JAX package to the PyTorch port."""

from torch_semantic_segmentation_tpu_torch.compat.torch_loader import (
    state_dict_from_jax,
)

__all__ = ["state_dict_from_jax"]
