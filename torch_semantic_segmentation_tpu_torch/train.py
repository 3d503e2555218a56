"""Training step of the port: forward, loss, backward and the optimizer
update with its LR schedule (the JAX package's `train.py`).

The JAX step is one jit-compiled program that donates the old state's
buffers; here the step runs eagerly and updates the model's parameters,
its BatchNorm running statistics and the optimizer's state in place.

    cfg = OptimizerConfig(lr=0.045, max_steps=1000)
    state = create_train_state(model, cfg)
    step = make_train_step(model, state, resize_cross_entropy_loss)
    metrics = step(images, labels)          # {"loss": scalar tensor}
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch
from torch import nn

from torch_semantic_segmentation_tpu_torch.device import resolve_device
from torch_semantic_segmentation_tpu_torch.losses import cross_entropy_loss


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


def make_train_step(model: nn.Module, state: TrainState,
                    loss_fn: LossFn | None = None, *,
                    device: str | torch.device | None = None
                    ) -> tp.Callable[[tp.Any, tp.Any],
                                     dict[str, torch.Tensor]]:
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
    """
    dev = resolve_device(device)
    if loss_fn is None:
        loss_fn = cross_entropy_loss
    optimizer, scheduler = state

    def step(images, labels) -> dict[str, torch.Tensor]:
        images = torch.as_tensor(images).to(dev)
        labels = torch.as_tensor(labels).to(dev)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model(images), labels)
        loss.backward()
        optimizer.step()
        scheduler.step()
        return {"loss": loss.detach()}

    return step
