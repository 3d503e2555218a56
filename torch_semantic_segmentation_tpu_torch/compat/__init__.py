"""Weight carry into the PyTorch port: from the JAX package, and from torch
checkpoint files with their keys mapped."""

from torch_semantic_segmentation_tpu_torch.compat.key_maps import (
    MODEL_KEY_ALIASES,
    alias_key_map,
    auto_key_map,
    load_with_auto_map,
    strip_state_dict_prefixes,
)
from torch_semantic_segmentation_tpu_torch.compat.torch_loader import (
    import_state_dict,
    load_torch_checkpoint,
    state_dict_from_jax,
)

__all__ = ["MODEL_KEY_ALIASES", "alias_key_map", "auto_key_map",
           "import_state_dict", "load_torch_checkpoint", "load_with_auto_map",
           "state_dict_from_jax", "strip_state_dict_prefixes"]
