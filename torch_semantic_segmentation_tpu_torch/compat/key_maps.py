"""Checkpoint key-name robustness of the port (the JAX package's
`compat/key_maps.py`).

The port's state-dict keys are the JAX package's canonical torch keys (its
attribute paths). A checkpoint written by another torch implementation may
name the same tensors differently; this module makes the import path
robust to any naming scheme that preserves module registration order:

1. `alias_key_map(table)` — a `key_map` callable from a plain
   prefix/substring rewrite table (`downsample.*` vs `skip.*`,
   `nn.Sequential` integer paths vs named attributes, ...).

2. `auto_key_map(model, state_dict)` — a *structural* matcher: aligns the
   model's ordered (canonical key, shape) sequence against the
   checkpoint's ordered (key, shape) items and returns a key map dict.
   torch's `state_dict()` iterates in registration order, so order + shape
   alignment recovers the correspondence whatever the strings are;
   misalignment raises with context instead of guessing.

3. `MODEL_KEY_ALIASES` — per-model alias tables for plausible public
   naming schemes.

The model's sequence is the JAX package's walk: each module's own
parameters, then its children, in attribute order. `nn.Module.state_dict()`
lists a module's own tensors before its children's, which is the same walk
wherever no module holds both its own tensors and child modules: the case
for all 13 zoo models (`tests/test_torch_compat.py` holds the two
sequences equal for each). `_model_param_sequence` raises on such a module
rather than guess the interleaving.
"""

from __future__ import annotations

import typing as tp
import warnings

import torch
from torch import nn


def alias_key_map(table: tp.Mapping[str, str],
                  *, strip_prefixes: tp.Sequence[str] = ("module.",)
                  ) -> tp.Callable[[str], str]:
    """key_map callable: rewrite canonical keys via first-match table.

    Each table entry `old -> new` is applied as a prefix rewrite if `old`
    ends with '.', else as a whole-segment substring rewrite. Checkpoint-
    side DDP/`module.` prefixes are handled at load time by
    `strip_state_dict_prefixes` — `strip_prefixes` here is kept for
    symmetry when the *canonical* key carries a prefix.
    """
    def key_map(key: str) -> str:
        for p in strip_prefixes:
            if key.startswith(p):
                key = key[len(p):]
        for old, new in table.items():
            if old.endswith("."):
                if key.startswith(old):
                    key = new + key[len(old):]
            else:
                parts = key.split(".")
                parts = [new if s == old else s for s in parts]
                key = ".".join(parts)
        return key
    return key_map


def strip_state_dict_prefixes(state_dict: tp.Mapping[str, tp.Any],
                              prefixes: tp.Sequence[str] = ("module.",)
                              ) -> dict[str, tp.Any]:
    """Remove wrapper prefixes (DDP's `module.`, lightning's `model.`)
    from checkpoint keys."""
    out = {}
    for k, v in state_dict.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
        out[k] = v
    return out


# Plausible public naming schemes per model family (the JAX package's
# tables): apply via alias_key_map(MODEL_KEY_ALIASES[name]), or fall back to
# auto_key_map, which needs no table at all.
MODEL_KEY_ALIASES: dict[str, dict[str, str]] = {
    "enet": {
        "initial": "initial_block",     # common alt name in ENet ports
        "skip": "downsample",
    },
    "deeplabv3_resnet18": {"stem": "conv1", "head": "classifier"},
    "deeplabv3_resnet34": {"stem": "conv1", "head": "classifier"},
    "deeplabv3_resnet50": {"stem": "conv1", "head": "classifier"},
    "deeplabv3_resnet101": {"stem": "conv1", "head": "classifier"},
    "bisenet": {"spatial": "spatial_path", "context": "context_path",
                "arm16": "arm1", "arm32": "arm2"},
    "icnet": {"cff12": "cff_12", "cff24": "cff_24"},
}


def _is_counter(k: str, v) -> bool:
    """BatchNorm num_batches_tracked — may itself be renamed, so identify
    it structurally too: the only 0-d integer tensors in a convnet
    state_dict."""
    if k.endswith("num_batches_tracked"):
        return True
    t = torch.as_tensor(v)
    return t.ndim == 0 and not (t.is_floating_point() or t.is_complex())


def _model_param_sequence(model: nn.Module) -> list[tuple[str, tuple[int, ...]]]:
    """Ordered (canonical key, shape) for every tensor the importer looks
    up, in the JAX package's module walk order (BatchNorm counters left
    out: the JAX package keeps none)."""
    for path, mod in model.named_modules():
        own = list(mod._parameters) + list(mod._buffers)
        if own and any(True for _ in mod.children()):
            raise ValueError(
                f"module '{path}' holds its own tensors {own} and child "
                "modules: its walk order is not its state dict's")
    return [(k, tuple(v.shape)) for k, v in model.state_dict().items()
            if not _is_counter(k, v)]


def auto_key_map(model: nn.Module, state_dict: tp.Mapping[str, tp.Any]
                 ) -> dict[str, str]:
    """Structurally align `state_dict` onto `model` and return a
    {canonical_key: checkpoint_key} dict (pass `key_map=mapping.get`).

    Works for ANY renaming that preserves torch registration order. Raises
    ValueError with aligned context on count or shape mismatch (a wrong
    architecture, not a naming difference).
    """
    want = _model_param_sequence(model)
    have = [(k, tuple(torch.as_tensor(v).shape))
            for k, v in state_dict.items() if not _is_counter(k, v)]
    if len(want) != len(have):
        raise ValueError(
            f"parameter count mismatch: model expects {len(want)} tensors, "
            f"checkpoint has {len(have)} (excluding num_batches_tracked) — "
            "not a naming difference; check the architecture/variant")
    have_pos = {k: i for i, (k, _) in enumerate(have)}
    mapping = {}
    suspicious = []
    for i, ((wk, ws), (hk, hs)) in enumerate(zip(want, have)):
        if ws != hs:
            raise ValueError(
                f"shape mismatch at position {i}: model '{wk}' {ws} vs "
                f"checkpoint '{hk}' {hs} — ordering diverged or wrong "
                "architecture; try an alias table (MODEL_KEY_ALIASES) or "
                "inspect the checkpoint key order")
        mapping[wk] = hk
        # The one silent failure mode of positional matching: two
        # same-shape tensors registered in a different order zip cleanly
        # but load swapped. When the checkpoint uses the SAME naming scheme
        # (the model's exact key exists in it) yet sits at a different
        # position, the order genuinely diverged — warn.
        if hk != wk and wk in have_pos:
            suspicious.append((i, wk, hk))
    if suspicious:
        ex = "; ".join(f"#{i} model '{w}' <- ckpt '{h}'"
                       for i, w, h in suspicious[:5])
        warnings.warn(
            f"auto_key_map: {len(suspicious)} positionally-aligned pairs "
            f"map a model key that ALSO exists verbatim in the checkpoint "
            f"at a different position ({ex}). Shapes match, so they would "
            "load silently — but registration order likely diverged and "
            "same-shape tensors may be swapped. Spot-check logits against "
            "the source model after import.",
            stacklevel=2)
    return mapping


def load_with_auto_map(model: nn.Module, state_dict: tp.Mapping[str, tp.Any],
                       **kwargs) -> list[str]:
    """Import `state_dict` into `model` tolerating arbitrary key renames
    (order/shape-aligned). DDP `module.` prefixes are stripped first; the
    (possibly renamed) BN counters are dropped, so they restart at 0."""
    from torch_semantic_segmentation_tpu_torch.compat.torch_loader import (
        import_state_dict)
    sd = strip_state_dict_prefixes(state_dict)
    mapping = auto_key_map(model, sd)
    sd = {k: v for k, v in sd.items() if not _is_counter(k, v)}
    return import_state_dict(model, sd, key_map=lambda k: mapping.get(k, k),
                             **kwargs)
