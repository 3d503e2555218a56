"""Serving path: uint8 NHWC frames → class ids, probabilities or logits.

`make_predict_fn(model)` puts the model in eval mode and folds BatchNorm
into its convs (`ops.fold.fold_batchnorm`) in place, as the JAX package
does; the predictor then serves a copy of the folded model of its own,
as JAX's serves the `nnx.split` snapshot it took: the weights of build
time. A later change to the model (an optimizer step, `load_state_dict`,
an in-place edit) does not reach a predictor that already exists. The
frames are normalised on the device and the model runs under
`torch.inference_mode()`. With the model's compute dtype set to bfloat16
the convs run in bf16. Models built with `upsample_logits=False` return
1/8-resolution logits; for `output="ids"` the ×8 resize runs fused with
the argmax (`ops.resize_argmax`).

`aot_compile(predict, batch, height, width)` prepares a predictor for one
frame shape before the first request, so that no request pays for
building the kernels, filling the first-use caches or choosing the
library's algorithms. On the card it then captures the whole predictor,
normalisation to output, as one CUDA graph, which each request replays.
"""

from __future__ import annotations

import copy
import functools
import time
import traceback
import typing as tp
from pathlib import Path

import torch
import torch.nn.functional as F
from torch import nn

from torch_semantic_segmentation_tpu_torch import kernels, profiling
from torch_semantic_segmentation_tpu_torch.data.transforms import (
    CITYSCAPES_MEAN, CITYSCAPES_STD)
from torch_semantic_segmentation_tpu_torch.device import resolve_device
from torch_semantic_segmentation_tpu_torch.ops.fold import fold_batchnorm
from torch_semantic_segmentation_tpu_torch.ops.upsample import (
    resize_argmax, resize_bilinear)
from torch_semantic_segmentation_tpu_torch.parallel import distributed

_OUTPUTS = ("ids", "probs", "logits")
_PKG = str(Path(__file__).resolve().parent)

# eager calls before the capture: the first builds the kernels and fills
# the caches, the second runs as every later call does
WARMUP_CALLS = 2


class Predictor:
    """What `make_predict_fn` returns: uint8 NHWC frames (a tensor or a
    numpy array) → a fresh tensor on `device`, from the model it holds."""

    def __init__(self, model: nn.Module, mean, std, output: str,
                 device: torch.device):
        self.model, self.output, self.device = model, output, device
        self.mean = torch.tensor(mean, dtype=torch.float32,
                                 device=device) * 255.0
        self.std = torch.tensor(std, dtype=torch.float32,
                                device=device) * 255.0
        # low-res-logit models upsample here, with the model's own convention
        self.align_corners = bool(getattr(model, "align_corners", False))

    @torch.inference_mode()
    def __call__(self, frames) -> torch.Tensor:
        return self.run(torch.as_tensor(frames).to(self.device))

    def run(self, frames: torch.Tensor) -> torch.Tensor:
        """The predictor on uint8 frames already on its device: the part
        that `aot_compile` captures. Call it in inference mode."""
        x = (frames.float() - self.mean) / self.std
        logits = self.model(x)
        if isinstance(logits, (tuple, list)):
            logits = logits[0]
        size = (frames.shape[1], frames.shape[2])
        low_res = (logits.shape[1], logits.shape[2]) != size
        if self.output == "ids":
            if low_res:
                return resize_argmax(logits, size,
                                     align_corners=self.align_corners)
            return torch.argmax(logits, dim=-1).to(torch.uint8)
        if low_res:
            logits = resize_bilinear(logits, size,
                                     align_corners=self.align_corners)
        if self.output == "probs":
            return F.softmax(logits.float(), dim=-1)
        return logits


def make_predict_fn(
    model: nn.Module,
    *,
    fold_bn: bool = True,
    mean: tp.Sequence[float] = CITYSCAPES_MEAN,
    std: tp.Sequence[float] = CITYSCAPES_STD,
    output: str = "ids",
    device: str | torch.device | None = None,
) -> Predictor:
    """Build the predictor: uint8 NHWC frames (a tensor or numpy array) →
    a tensor on `device` (the card unless the caller passes "cpu"). The
    caller's model is moved to `device`, put in eval mode and folded; the
    predictor serves its own copy of it."""
    if output not in _OUTPUTS:
        raise ValueError(f"output must be one of {_OUTPUTS}, got {output!r}")
    dev = resolve_device(device)
    model.to(dev).eval()
    if fold_bn:
        fold_batchnorm(model)
    # an eval model draws no dropout: the copy shares the model's generators
    shared = {id(v): v for m in model.modules() for v in vars(m).values()
              if isinstance(v, torch.Generator)}
    served = copy.deepcopy(model, shared).requires_grad_(False)
    return Predictor(served, mean, std, output, dev)


def aot_compile(predict_fn: Predictor, batch: int, height: int,
                width: int) -> "CompiledPredictor":
    """Prepare `predict_fn` (from `make_predict_fn`) ahead of time for
    uint8 frames of shape (batch, height, width, 3), the JAX package's
    `serving.aot_compile`. The callable it returns takes only that shape
    and dtype (anything else raises TypeError, as JAX's compiled executable
    does) and returns a fresh tensor equal to what `predict_fn` returns, on
    its device. On the card it is one CUDA graph (`CompiledPredictor`); on
    the CPU it checks the frames and calls `predict_fn`.

    Raises NotImplementedError under spatial sharding (JAX's compiles for
    one device's unsharded frames), RuntimeError while
    `kernels.CHECK_FINITE` is on (its checks read the card from the host,
    which a graph cannot hold), and TypeError for a callable that did not
    come from `make_predict_fn`."""
    if not isinstance(predict_fn, Predictor):
        raise TypeError(f"aot_compile takes a predictor from make_predict_fn, "
                        f"got {type(predict_fn).__name__}")
    if distributed.is_spatial():
        raise NotImplementedError(
            f"aot_compile under spatial sharding (num_spatial="
            f"{distributed.num_spatial()}): it compiles for one device's "
            "unsharded frames, as the JAX package's does")
    if kernels.CHECK_FINITE:
        raise RuntimeError(
            "aot_compile while NaN debugging is on (kernels.CHECK_FINITE): "
            "its checks read the card from the host, which a CUDA graph "
            "cannot hold")
    return CompiledPredictor(predict_fn, (batch, height, width, 3))


class CompiledPredictor:
    """`aot_compile`'s callable. On the card: the frames are copied into a
    static uint8 buffer on the device (outside the graph), the graph is
    replayed, and the graph's output is returned as a clone, so a later
    call never overwrites an earlier result. It serves the weights its
    predictor held when it was compiled; its graph and the graph's memory
    pool are freed with it.

    `held`: each kernel's launches inside the graph (by the names of
    `profiling.launch_counts`); a replay launches them again without
    counting them.
    `replays`: the replays so far. `seconds`: the compile's wall time,
    warm-up included."""

    def __init__(self, predict: Predictor, shape: tuple[int, ...]):
        self.predict, self.shape = predict, shape
        self.held: dict[str, int] = {}
        self.replays = 0
        self.graph: torch.cuda.CUDAGraph | None = None
        t0 = time.perf_counter()
        if predict.device.type == "cuda":
            self._capture()
        self.seconds = time.perf_counter() - t0

    def _capture(self):
        dev = self.predict.device
        self.frames = torch.zeros(self.shape, dtype=torch.uint8, device=dev)
        stream, caller = _capture_stream(dev), torch.cuda.current_stream(dev)
        stream.wait_stream(caller)
        with torch.inference_mode(), torch.cuda.stream(stream):
            for _ in range(WARMUP_CALLS):
                self.predict.run(self.frames)
        caller.wait_stream(stream)
        before = profiling.launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.inference_mode(), torch.cuda.graph(
                    graph, stream=stream, capture_error_mode="thread_local"):
                out = self.predict.run(self.frames)
        except Exception as err:
            # a capture that fails leaves its stream current
            torch.cuda.set_stream(caller)
            raise RuntimeError(
                f"aot_compile: capturing the predictor for uint8 frames of "
                f"shape {self.shape} as a CUDA graph failed: "
                f"{_first_failure(err)}") from err
        after = profiling.launch_counts()
        self.held = {k: after[k] - before[k] for k in after
                     if after[k] != before[k]}
        self.graph, self.out = graph, out

    def __call__(self, frames) -> torch.Tensor:
        frames = torch.as_tensor(frames)
        if tuple(frames.shape) != self.shape or frames.dtype != torch.uint8:
            raise TypeError(
                f"compiled for uint8 frames of shape {self.shape}, got "
                f"{frames.dtype} of shape {tuple(frames.shape)}")
        if self.graph is None:
            return self.predict(frames)
        with torch.inference_mode():
            self.frames.copy_(frames)
            self.graph.replay()
            self.replays += 1
            return self.out.clone()


@functools.lru_cache(maxsize=None)
def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream of every warm-up and capture on `device`: the
    library handles' workspaces for it are made once, in the first
    warm-up, outside any capture."""
    return torch.cuda.Stream(device)


def _first_failure(err: BaseException) -> str:
    """The first error of `err`'s chain (where a capture fails, the end of
    the capture then reports it invalidated) and the port's deepest line
    in its traceback: the operation the graph could not hold."""
    while err.__context__ is not None:
        err = err.__context__
    frames = [f for f in traceback.extract_tb(err.__traceback__)
              if f.filename.startswith(_PKG)]
    at = ""
    if frames:
        f = frames[-1]
        at = (f" at {Path(f.filename).relative_to(_PKG)}:{f.lineno} "
              f"({f.line})")
    return f"{type(err).__name__}: {err}{at}"
