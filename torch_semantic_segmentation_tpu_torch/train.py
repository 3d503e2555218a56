"""Training and eval steps of the port: forward, loss, backward and the
optimizer update with its LR schedule, and the confusion-matrix eval step
(the JAX package's `train.py`).

The JAX step is one jit-compiled program that donates the old state's
buffers; here the step runs eagerly and updates the model's parameters,
its BatchNorm running statistics and the optimizer's state in place.

Under a process group (`parallel.distributed`) each rank steps on its rows
of the global batch: BatchNorm, the folded moments and the losses reduce
their statistics over ranks inside the forward, the gradients are summed
over ranks in one collective after the backward, and the loss the step
returns is the global batch's on every rank.

    cfg = OptimizerConfig(lr=0.045, max_steps=1000)
    state = create_train_state(model, cfg)
    step = make_train_step(model, state, resize_cross_entropy_loss)
    metrics = step(images, labels)          # {"loss": scalar tensor}
    ev = make_eval_step(model, num_classes=19)
    cm = ev(new_confusion_matrix(19), images, labels)
"""

from __future__ import annotations

import contextlib
import dataclasses
import typing as tp

import torch
import torch.utils.checkpoint
from torch import nn

from torch_semantic_segmentation_tpu_torch import metrics
from torch_semantic_segmentation_tpu_torch.device import resolve_device
from torch_semantic_segmentation_tpu_torch.losses import cross_entropy_loss
from torch_semantic_segmentation_tpu_torch.models import check_spatial_model
from torch_semantic_segmentation_tpu_torch.ops import conv, mbconv
from torch_semantic_segmentation_tpu_torch.ops.dropout import Dropout
from torch_semantic_segmentation_tpu_torch.ops.upsample import resize_argmax
from torch_semantic_segmentation_tpu_torch.parallel import distributed


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """SGD with momentum and poly LR (the reference's recipe), or AdamW.

    lr(t) = lr · (1 − min(t, max_steps)/max_steps)^power, counted from t=0
    as optax's polynomial_schedule does.
    - sgd: `optax.add_decayed_weights` → `trace(momentum)` →
      `scale_by_learning_rate`: coupled weight decay on every parameter
      (BN scale and bias and conv biases too), added to the gradient
      before the momentum, no dampening, no Nesterov — torch's SGD.
    - adamw: `optax.adamw(schedule, weight_decay)`: decoupled decay scaled
      by the LR, eps outside the square root — torch's AdamW.
    """
    lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 1e-4
    power: float = 0.9
    max_steps: int = 10_000
    optimizer: str = "sgd"  # or "adamw"

    def poly(self, t: int) -> float:
        """The schedule's factor at update t (0 for the first update)."""
        return (1.0 - min(t, self.max_steps) / self.max_steps) ** self.power

    def make(self, params: tp.Iterable[torch.Tensor]) -> TrainState:
        params = list(params)
        if self.optimizer == "sgd":
            opt: torch.optim.Optimizer = torch.optim.SGD(
                params, lr=self.lr, momentum=self.momentum, dampening=0.0,
                weight_decay=self.weight_decay, nesterov=False)
        elif self.optimizer == "adamw":
            opt = torch.optim.AdamW(params, lr=self.lr, betas=(0.9, 0.999),
                                    eps=1e-8, weight_decay=self.weight_decay)
        else:
            raise ValueError(f"unknown optimizer {self.optimizer!r}: "
                             "'sgd' or 'adamw'")
        return TrainState(opt, torch.optim.lr_scheduler.LambdaLR(opt, self.poly))


class TrainState(tp.NamedTuple):
    """The optimizer and its LR schedule; the model holds the parameters
    and the BN statistics."""
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR


def create_train_state(model: nn.Module, config: OptimizerConfig) -> TrainState:
    """Put the model in train mode and build its optimizer over every
    parameter."""
    model.train()
    return config.make(model.parameters())


LossFn = tp.Callable[[tp.Any, torch.Tensor], torch.Tensor]


def _remat_contexts(segment: nn.Module):
    """`context_fn` of one checkpointed segment: the contexts of its first
    forward and of its recompute in the backward. The recompute must not
    move the segment's BN running statistics a second time, and must draw
    the same dropout masks: checkpoint restores torch's global RNG, not the
    explicit generators the dropout layers draw from. So the first forward
    notes the generators' states; the recompute starts from them, drops its
    running-statistics updates (`conv.deferred_running_stats`), and puts
    back the generators' states it found when it ends."""
    gens = list({id(m.generator): m.generator for m in segment.modules()
                 if isinstance(m, Dropout) and m.generator is not None
                 }.values())

    def contexts():
        noted: list[torch.Tensor] = []

        @contextlib.contextmanager
        def forward():
            noted[:] = [g.get_state() for g in gens]
            yield

        @contextlib.contextmanager
        def recompute():
            after = [g.get_state() for g in gens]
            for g, s in zip(gens, noted):
                g.set_state(s)
            try:
                with conv.deferred_running_stats():
                    yield
            finally:
                for g, s in zip(gens, after):
                    g.set_state(s)

        return forward(), recompute()

    return contexts


@contextlib.contextmanager
def _checkpointed(model: nn.Module):
    """Within the block each of the model's `remat_segments()` runs under a
    non-reentrant `torch.utils.checkpoint` of its own, with K2 suppressed
    in its forward and its recompute. A segment keeps its inputs for the
    backward and no activation inside it; the backward recomputes one
    segment at a time, so only that segment's activations are held at
    once. A model without `remat_segments` is one segment, as the JAX
    package's `nnx.remat` wraps any model's whole forward."""
    segments = (model.remat_segments() if hasattr(model, "remat_segments")
                else [model])
    for seg in segments:
        def run(*args, _forward=seg.forward):
            with mbconv.suppress_routing():
                return _forward(*args)

        def call(*args, _run=run, _contexts=_remat_contexts(seg)):
            return torch.utils.checkpoint.checkpoint(
                _run, *args, use_reentrant=False, context_fn=_contexts)

        seg.forward = call
    try:
        yield
    finally:
        for seg in segments:
            del seg.forward


def make_train_step(model: nn.Module, state: TrainState,
                    loss_fn: LossFn | None = None, *, remat: bool = False,
                    device: str | torch.device | None = None
                    ) -> tp.Callable[..., dict[str, torch.Tensor]]:
    """The train step: `step(images, labels) -> {"loss": tensor}`, on
    `device` (the card unless the caller passes "cpu"; the model must
    already be there).

    `loss_fn(outputs, labels)` defaults to plain CE with ignore_index=255.
    Each call moves the batch to the device, runs the model in train mode,
    backpropagates, applies one optimizer update at the schedule's current
    LR and advances the schedule. Where the JAX step donates its input
    state and returns a new one, this step updates the model, its BN
    running statistics and the optimizer state in place. The loss stays on
    the device (no host sync).

    `remat=True` keeps only the inputs of the model's segments for the
    backward, which runs each segment's forward again (`_checkpointed`;
    FastSCNN's segments are its LDS convs, GFE blocks, PPM, FFM and
    classifier, UNet's its DoubleConvs, UpBlocks and head, DeepLabV3's its
    backbone's stem and stages, ASPP and heads; any other model is one
    segment). As in the JAX package, the fused expand → depthwise op
    (K2) is off inside them (`mbconv.suppress_routing`): its saving of the
    expanded tensor is moot there. The running statistics move once a
    step and the recompute sees the forward's dropout masks
    (`_remat_contexts`).

    Under a process group `images` and `labels` are the rank's rows of the
    global batch. The loss function returns the rank's share of the global
    loss, whose backward gives the rank's part of the global gradient;
    `distributed.all_reduce_gradients` sums the parts (one collective, so
    no `DistributedDataParallel` wrapper: its average would need the loss
    scaled by R, and its unused-parameter rule fails heads that take no
    gradient), and "loss" is the sum of the shares.

    `step(images, labels, before_update=fn)` calls `fn(metrics, model)`
    after the backward (and the gradients' reduction) and before the update,
    with BatchNorm's running-statistics updates held back until `fn`
    returns: where `fn` raises, the parameters, the running statistics,
    the optimizer and the schedule stay as they were (`debug.checked_step`).

    Under spatial sharding the batch is the rank's band of its rows
    (`parallel.shard_batch(spatial=True, max_stride=model.max_stride)`,
    bands of any split; images or labels whose rows are not the rank's
    band of the recorded split raise ValueError before the model runs,
    `distributed.check_band`); every zoo model takes it
    (`models.check_spatial_model`), with remat too: a segment's recompute
    exchanges its halos and reduces its moments again, as the JAX
    package's `jax.checkpoint` reruns GSPMD's exchanges, in the order of
    the forward on every rank (the exchanges block, so the messages of a
    recompute and of the backward never meet); its running statistics
    stay held back and its dropout masks are the forward's, cut by the
    same split.
    """
    dev = resolve_device(device)
    check_spatial_model(model)
    if loss_fn is None:
        loss_fn = cross_entropy_loss
    optimizer, scheduler = state

    def step(images, labels, *, before_update=None
             ) -> dict[str, torch.Tensor]:
        images = torch.as_tensor(images).to(dev)
        labels = torch.as_tensor(labels).to(dev)
        distributed.check_band(images.shape[1], "images")
        distributed.check_band(labels.shape[1], "labels")
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with (conv.deferred_running_stats() if before_update is not None
              else contextlib.nullcontext()) as pending:
            with _checkpointed(model) if remat else contextlib.nullcontext():
                outputs = model(images)
            loss = loss_fn(outputs, labels)
            loss.backward()
        distributed.all_reduce_gradients(model.parameters())
        metrics = {"loss": distributed.reduce_sum(loss.detach())}
        if before_update is not None:
            before_update(metrics, model)
            conv.apply_running_stats(pending)
        optimizer.step()
        scheduler.step()
        return metrics

    step.takes_before_update = True
    return step


def make_eval_step(model: nn.Module, *, num_classes: int,
                   ignore_index: int = 255,
                   device: str | torch.device | None = None
                   ) -> tp.Callable[[torch.Tensor, tp.Any, tp.Any],
                                    torch.Tensor]:
    """The eval step: `step(cm, images, labels) -> cm`, on `device` (the
    card unless the caller passes "cpu"; the model must already be there).

    Each call runs the model in eval mode with its BN unfolded, under
    `torch.inference_mode()`; 1/8-resolution logits go through the fused ×8
    resize + argmax, full-resolution ones through an argmax; the ids update
    the int64 confusion matrix (`metrics.update_confusion_matrix`). Only the
    (C, C) matrix need leave the device. Under spatial sharding the batch
    is the rank's band (any zoo model): each rank counts its band's
    pixels, and `eval.evaluate` sums the matrices; a band cut off the
    recorded split raises as in the train step."""
    dev = resolve_device(device)
    check_spatial_model(model)
    align_corners = bool(getattr(model, "align_corners", False))

    @torch.inference_mode()
    def step(cm: torch.Tensor, images, labels) -> torch.Tensor:
        if tuple(cm.shape) != (num_classes, num_classes):
            raise ValueError(f"confusion matrix {tuple(cm.shape)}, expected "
                             f"{(num_classes, num_classes)}")
        images = torch.as_tensor(images).to(dev)
        labels = torch.as_tensor(labels).to(dev)
        distributed.check_band(images.shape[1], "images")
        distributed.check_band(labels.shape[1], "labels")
        model.eval()
        logits = model(images)
        if isinstance(logits, (tuple, list)):
            logits = logits[0]
        size = (labels.shape[1], labels.shape[2])
        if (logits.shape[1], logits.shape[2]) != size:
            preds = resize_argmax(logits, size, align_corners=align_corners,
                                  out_dtype=torch.int32)
        else:
            preds = torch.argmax(logits, dim=-1)
        return metrics.update_confusion_matrix(cm, preds, labels,
                                               ignore_index=ignore_index)

    return step
