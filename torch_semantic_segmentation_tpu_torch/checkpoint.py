"""Checkpoint and resume of the port (the JAX package's `checkpoint.py`,
which wraps orbax): torch-native files, saved asynchronously, finalised
atomically, resumed from the newest.

A checkpoint is the directory `<directory>/<step>/` holding one file,
`checkpoint.pt`, a plain dict (so `torch.load(weights_only=True)` reads it):

- `"step"`: the step, as the caller counts it (the batches consumed);
- `"model"`: the model's state dict, BatchNorm's running statistics and
  `num_batches_tracked` included;
- `"optimizer"`, `"scheduler"`: the state dicts of the optimizer (SGD's
  momentum buffers) and of its `LambdaLR`;
- `"generators"`: the states of the generators passed in, in order (the
  augmentation generator, `model.dropout_generator`).

`save` takes its host copy of all of it before it returns (the train step
updates the parameters and the momentum in place); a thread writes the
file into a temporary directory and `os.replace`s it to `<step>/`, then
prunes to `max_to_keep`. So a run killed mid-write resumes from the last
complete step. Which steps are saved and kept follows orbax's
`CheckpointManager` as the JAX package configures it: a step is saved when
it is a multiple of `save_interval_steps` or no checkpoint exists yet, and
is newer than the latest; `force=True` saves any new step; the newest
`max_to_keep` are kept.
"""

from __future__ import annotations

import concurrent.futures
import os
import shutil
import tempfile
import typing as tp

import torch
from torch import nn

FILE = "checkpoint.pt"


def _host_copy(obj):
    """A copy of a state dict's tree with every tensor copied to the host:
    later in-place updates on the card or the CPU do not reach it."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def snapshot(step: int, model: nn.Module, state, *,
             generators: tp.Sequence[torch.Generator] = ()) -> dict:
    """What a checkpoint holds, copied to the host now."""
    optimizer, scheduler = state
    return {"step": int(step),
            "model": _host_copy(model.state_dict()),
            "optimizer": _host_copy(optimizer.state_dict()),
            "scheduler": _host_copy(scheduler.state_dict()),
            "generators": [g.get_state().clone() for g in generators]}


class CheckpointManager:
    """Periodic asynchronous checkpoints of a training run, and resume."""

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 save_interval_steps: int = 1000):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self._steps = sorted(int(d) for d in os.listdir(self._dir)
                             if d.isdigit() and os.path.exists(
                                 os.path.join(self._dir, d, FILE)))
        self._writer = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: list[concurrent.futures.Future] = []

    @property
    def directory(self) -> str:
        return self._dir

    def all_steps(self) -> list[int]:
        """The steps saved or being saved and not pruned, oldest first."""
        return list(self._steps)

    def latest_step(self) -> int | None:
        """Newest saved step (a save in flight counts), or None."""
        return self._steps[-1] if self._steps else None

    def should_save(self, step: int) -> bool:
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        return step % self.save_interval_steps == 0 or latest is None

    def save(self, step: int, model: nn.Module, state, *,
             generators: tp.Sequence[torch.Generator] = (),
             force: bool = False) -> bool:
        """Start a save of (model, state, generators) at `step` unless the
        policy skips it; returns whether a save was started. The host copy
        is taken before it returns; the file is written by a thread (`wait`
        for it)."""
        if not force and not self.should_save(step):
            return False
        if step in self._steps:
            raise ValueError(f"checkpoint for step {step} already exists")
        payload = snapshot(step, model, state, generators=generators)
        self._steps = sorted(self._steps + [step])
        pruned = self._steps[:-self.max_to_keep] if self.max_to_keep else []
        self._steps = self._steps[len(pruned):]
        self._pending.append(self._writer.submit(self._write, payload,
                                                 pruned))
        return True

    def _write(self, payload: dict, pruned: list[int]):
        final = os.path.join(self._dir, str(payload["step"]))
        tmp = tempfile.mkdtemp(prefix=f".{payload['step']}.", dir=self._dir)
        try:
            torch.save(payload, os.path.join(tmp, FILE))
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for step in pruned:
            shutil.rmtree(os.path.join(self._dir, str(step)),
                          ignore_errors=True)

    def wait(self):
        """Block until every started save is on disk; re-raises a failed
        write."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self):
        self.wait()
        self._writer.shutdown()

    def load(self, step: int | None = None) -> dict | None:
        """The checkpoint at `step` (default: the newest) as saved, on the
        host, or None when there is none."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(os.path.join(self._dir, str(step), FILE),
                          map_location="cpu", weights_only=True)

    def restore_latest(self, model: nn.Module, state, *,
                       generators: tp.Sequence[torch.Generator] = ()
                       ) -> int | None:
        """Load the newest checkpoint into the model, the optimizer, its
        schedule and the generators (as many as were saved, in order), in
        place. Returns its step, or None when there is none."""
        ckpt = self.load()
        if ckpt is None:
            return None
        if len(generators) != len(ckpt["generators"]):
            raise ValueError(f"checkpoint at step {ckpt['step']} holds "
                             f"{len(ckpt['generators'])} generator states, "
                             f"{len(generators)} generators given")
        _load_model(model, ckpt)
        optimizer, scheduler = state
        optimizer.load_state_dict(ckpt["optimizer"])
        scheduler.load_state_dict(ckpt["scheduler"])
        for g, s in zip(generators, ckpt["generators"]):
            g.set_state(s)
        return ckpt["step"]

    def restore_model(self, model: nn.Module) -> int | None:
        """Load only the newest checkpoint's model state (parameters and BN
        statistics) into `model`, ignoring the optimizer's: evaluation
        needs no optimizer. Returns the step, or None when there is none.
        Raises, naming the key, on a missing or extra key or a shape
        mismatch."""
        ckpt = self.load()
        if ckpt is None:
            return None
        _load_model(model, ckpt)
        return ckpt["step"]


def _load_model(model: nn.Module, ckpt: dict):
    saved = ckpt["model"]
    for key, want in model.state_dict().items():
        if key not in saved:
            raise KeyError(f"checkpoint at step {ckpt['step']} has no "
                           f"'{key}' — wrong model?")
        if tuple(saved[key].shape) != tuple(want.shape):
            raise ValueError(
                f"checkpoint at step {ckpt['step']}: '{key}' has shape "
                f"{tuple(saved[key].shape)}, the model {tuple(want.shape)} "
                "— wrong model?")
    extra = [k for k in saved if k not in model.state_dict()]
    if extra:
        raise KeyError(f"checkpoint at step {ckpt['step']} has keys the "
                       f"model lacks, e.g. '{extra[0]}' — wrong model?")
    model.load_state_dict(saved, strict=True)
