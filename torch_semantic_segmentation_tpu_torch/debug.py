"""Numeric sanitisation of the port (the JAX package's `debug.py`). The
failure it hunts is numeric: NaN or Inf from bf16 overflow, a bad LR, or a
mishandled ignore index.

- `enable_nan_debugging()`: the first operation whose floating output is
  not finite raises FloatingPointError naming it, as `jax_debug_nans` and
  `jax_debug_infs` do. In the forward a dispatch mode checks every ATen
  operation's output; in the backward `torch.autograd.set_detect_anomaly(
  check_nan=True)` names the backward function; the kernel wrappers check
  what their kernels wrote (`kernels.check_finite`), which no dispatch mode
  sees, so a kernel that makes the first NaN is the one named. Every check
  waits for the card: slow by design. An intended infinity trips it too
  (OHEM's exact route masks ignored pixels with −inf), as in JAX.
- `checked_step(step_fn)`: raises FloatingPointError("non-finite loss
  ...") when a step's loss is not finite. On the port's train step the
  check runs after the backward and before the update, with BatchNorm's
  running-statistics updates held back until it passes, so a step that
  raises leaves the parameters, the running statistics, the optimizer and
  the schedule as they were, without a copy of the state. There it also
  raises ("non-finite gradient of ...") where the loss is finite and a
  gradient is not: K1's and K3's clip to ±80 maps a NaN logit to −80 on
  the card, so a NaN can reach the gradients and not the loss. Under a
  process group the loss and the gradients are the global batch's, so
  every rank raises together.
"""

from __future__ import annotations

import typing as tp

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from torch_semantic_segmentation_tpu_torch import kernels
from torch_semantic_segmentation_tpu_torch.profiling import UNWRITTEN_OPS


class _FiniteMode(TorchDispatchMode):
    """Raise at the first ATen operation with a non-finite floating
    output."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._schema.name
        if func.is_view or name.startswith(UNWRITTEN_OPS):
            return out
        for t in tree_flatten(out)[0]:
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and not bool(t.isfinite().all())):
                raise FloatingPointError(
                    f"non-finite output of {name} ({func}), shape "
                    f"{tuple(t.shape)}")
        return out


_mode: _FiniteMode | None = None


def enable_nan_debugging(enable: bool = True) -> None:
    """Turn the checks on (or off) for this thread's forward and every
    backward."""
    global _mode
    torch.autograd.set_detect_anomaly(enable, check_nan=True)
    kernels.CHECK_FINITE = enable
    if enable and _mode is None:
        _mode = _FiniteMode()
        _mode.__enter__()
    elif not enable and _mode is not None:
        _mode.__exit__(None, None, None)
        _mode = None


def _raise_unless_finite(metrics, model=None) -> None:
    loss = metrics["loss"] if isinstance(metrics, dict) else metrics
    if not bool(torch.isfinite(torch.as_tensor(loss)).all()):
        raise FloatingPointError(f"non-finite loss {float(loss)}")
    if model is None:
        return
    grads = [(k, p.grad) for k, p in model.named_parameters()
             if p.grad is not None]
    if grads and not bool(torch.stack([g.isfinite().all()
                                       for _, g in grads]).all()):
        name = next(k for k, g in grads if not bool(g.isfinite().all()))
        raise FloatingPointError(f"non-finite gradient of {name} at a "
                                 f"finite loss {float(loss)}")


def checked_step(step_fn: tp.Callable) -> tp.Callable:
    """Wrap a step so that a non-finite loss raises FloatingPointError.
    The port's train step (`train.make_train_step`) checks between its
    backward and its update, its gradients too, and keeps its state where
    it raises; any other `step_fn(*args) -> metrics` (a dict with "loss",
    a loss, or a tuple ending in either) is checked after it returns."""
    if getattr(step_fn, "takes_before_update", False):
        def wrapped(*args, **kwargs):
            return step_fn(*args, before_update=_raise_unless_finite,
                           **kwargs)
        return wrapped

    def checked(*args, **kwargs):
        out = step_fn(*args, **kwargs)
        _raise_unless_finite(out[-1] if isinstance(out, tuple) else out)
        return out

    return checked
