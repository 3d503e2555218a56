"""Convolution building blocks, in PyTorch, with the JAX package's layout.

Every module here takes and returns NHWC tensors, as the JAX package's do.
Inside, a conv runs on the NCHW view `x.permute(0, 3, 1, 2)`, which for a
contiguous NHWC tensor is channels_last NCHW without a copy; the result
permutes back to contiguous NHWC the same way.

`compute_dtype` plays the part of `nnx.Conv(dtype=...)`: the input, the
weights and the bias are cast to it at call time, and the parameters stay
in their own (float32) storage type.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from torch_semantic_segmentation_tpu_torch.ops import depthwise
from torch_semantic_segmentation_tpu_torch.ops.sepconv import fuse_conv_pair

Act = tp.Optional[str]

# Depthwise convs over fewer pixels (N·H·W of the input) stay on the plain
# conv, as in the JAX package (`TPU_SEG_PALLAS_DW_MIN_PX`'s default). Tests
# may monkeypatch it.
DEPTHWISE_MIN_PX = 1 << 18

_ACTIVATIONS: dict[str, tp.Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "relu6": F.relu6,
    "gelu": F.gelu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "hardswish": F.hardswish,
    "silu": F.silu,
}


def _pair(v) -> tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def activation(name: Act) -> tp.Callable[[torch.Tensor], torch.Tensor]:
    """Resolve an activation name to a function (None → identity)."""
    if name is None or name == "identity":
        return lambda x: x
    return _ACTIVATIONS[name]


def _compute_types(x: torch.Tensor, param: torch.Tensor,
                   compute_dtype: torch.dtype | None) -> torch.dtype:
    """nnx's `promote_dtype`: the compute dtype if one is set, else the
    promotion of the input's and the parameters' types."""
    if compute_dtype is not None:
        return compute_dtype
    return torch.promote_types(x.dtype, param.dtype)


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` on NHWC tensors with a call-time compute dtype."""

    def __init__(self, *args, compute_dtype: torch.dtype | None = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_types(x, self.weight, self.compute_dtype)
        bias = self.bias.to(dt) if self.bias is not None else None
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), bias,
                     self.stride, self.padding, self.dilation, self.groups)
        return y.permute(0, 2, 3, 1)


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` on NHWC tensors with a call-time compute dtype and
    flax's `nnx.BatchNorm` numerics.

    Training mode (flax's `_compute_stats` and `_normalize`): the batch
    mean and the biased variance E[x²]−E[x]² (clipped at 0) in float32 over
    N, H and W; the running stats move in place as
    `(1−m)·running + m·batch`; the output is
    `(x − mean)·(rsqrt(var+eps)·scale) + bias` in float32, cast to the
    compute dtype. Gradients flow through the batch statistics."""

    def __init__(self, *args, compute_dtype: torch.dtype | None = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def update_running_stats(self, mean: torch.Tensor,
                             var: torch.Tensor) -> None:
        """Move the running stats toward a batch's float32 mean and biased
        variance, as flax does with momentum 1−m. `momentum=None` keeps
        torch's cumulative average (m = 1 / batches seen)."""
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            m = self.momentum
            if m is None:
                m = 1.0 / float(self.num_batches_tracked)
            self.running_mean.copy_((1 - m) * self.running_mean
                                    + m * mean.detach())
            self.running_var.copy_((1 - m) * self.running_var
                                   + m * var.detach())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_types(x, self.weight, self.compute_dtype)
        if self.training:
            xf = x.to(dt).float()
            mean = xf.mean(dim=(0, 1, 2))
            var = torch.clamp((xf * xf).mean(dim=(0, 1, 2)) - mean * mean,
                              min=0.0)
            self.update_running_stats(mean, var)
            # flax promotes scale and bias to the compute dtype first
            mul = torch.rsqrt(var + self.eps) * self.weight.to(dt).float()
            return ((xf - mean) * mul + self.bias.to(dt).float()).to(dt)
        # flax's _normalize: (x - mean) * (rsqrt(var + eps) * scale) + bias
        mul = torch.rsqrt(self.running_var.to(dt) + self.eps) * self.weight.to(dt)
        return (x.to(dt) - self.running_mean.to(dt)) * mul + self.bias.to(dt)


def make_conv(in_ch: int, out_ch: int, kernel_size, *, stride=1, padding=0,
              dilation=1, groups: int = 1, use_bias: bool = True,
              compute_dtype: torch.dtype | None = None,
              generator: torch.Generator | None = None) -> Conv2d:
    """Conv with torch Conv2d conventions: kaiming_uniform(a=√5) kernel and
    uniform(±1/√fan_in) bias, drawn from `generator`."""
    conv = Conv2d(in_ch, out_ch, _pair(kernel_size), stride=_pair(stride),
                  padding=_pair(padding), dilation=_pair(dilation),
                  groups=groups, bias=use_bias, compute_dtype=compute_dtype)
    kh, kw = _pair(kernel_size)
    bound = 1.0 / ((in_ch // groups) * kh * kw) ** 0.5
    with torch.no_grad():
        conv.weight.uniform_(-bound, bound, generator=generator)
        if conv.bias is not None:
            conv.bias.uniform_(-bound, bound, generator=generator)
    return conv


def make_norm(num_features: int, *, momentum: float = 0.1, eps: float = 1e-5,
              compute_dtype: torch.dtype | None = None) -> BatchNorm2d:
    """BatchNorm2d: torch momentum 0.1 (flax 0.9), eps 1e-5."""
    return BatchNorm2d(num_features, eps=eps, momentum=momentum,
                       compute_dtype=compute_dtype)


class ConvBNAct(nn.Module):
    """conv → BN → activation. `ops.fold.fold_batchnorm` folds the eval-mode
    BN into the conv, after which `bn` is None. A bias-free stride-2
    depthwise 3×3 runs through `ops.depthwise` (the Hopper kernel K6)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size=3, *, stride=1,
                 padding=None, dilation=1, groups: int = 1, act: Act = "relu",
                 use_bias: bool = False,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        dh, dw = _pair(dilation)
        if padding is None:  # 'same'-style default for odd kernels
            padding = (dh * (kh - 1) // 2, dw * (kw - 1) // 2)
        self.conv = make_conv(in_ch, out_ch, kernel_size, stride=stride,
                              padding=padding, dilation=dilation,
                              groups=groups, use_bias=use_bias,
                              compute_dtype=compute_dtype,
                              generator=generator)
        self.bn: BatchNorm2d | None = make_norm(out_ch,
                                                compute_dtype=compute_dtype)
        self.act_name = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._maybe_depthwise(x)
        if y is None:
            y = self.conv(x)
        if self.bn is not None:
            y = self.bn(y)
        return activation(self.act_name)(y)

    def _maybe_depthwise(self, x: torch.Tensor) -> torch.Tensor | None:
        """The JAX package's `ConvBNAct._maybe_pallas_dw` with its opt-in
        switch on: a depthwise 3×3 (groups = C = the input's channels),
        dilation 1, padding 1, stride 2, no bias, over at least
        `DEPTHWISE_MIN_PX` input pixels, whose compute dtype is x's, goes
        through `ops.depthwise` with the float32 kernel. Returns None where
        the conv does not qualify. Folding BN gives a conv a bias, so the
        serving path never routes here."""
        conv = self.conv
        c = x.shape[-1]
        if (conv.groups == 1 or conv.groups != c or conv.out_channels != c
                or conv.kernel_size != (3, 3) or conv.dilation != (1, 1)
                or conv.stride != (2, 2) or conv.padding != (1, 1)
                or conv.bias is not None):
            return None
        if not depthwise.supports(tuple(x.shape), 2, dtype=x.dtype):
            return None
        if x.shape[0] * x.shape[1] * x.shape[2] < DEPTHWISE_MIN_PX:
            return None
        if _compute_types(x, conv.weight, conv.compute_dtype) != x.dtype:
            return None
        k = conv.weight.reshape(c, 3, 3).permute(1, 2, 0)
        return depthwise.depthwise_conv3x3(x.contiguous(), k, 2)


class SeparableConv(nn.Module):
    """Depthwise-separable conv: depthwise(k) → BN → act → pointwise 1×1 →
    BN → act. Once BN is folded, a stride-1 3×3 pair runs as one fused
    kernel (`ops.sepconv`)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size=3, *, stride=1,
                 dilation=1, act: Act = "relu", relu_after_dw: bool = True,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dw = ConvBNAct(in_ch, in_ch, kernel_size, stride=stride,
                            dilation=dilation, groups=in_ch,
                            act=act if relu_after_dw else None,
                            compute_dtype=compute_dtype, generator=generator)
        self.pw = ConvBNAct(in_ch, out_ch, 1, act=act,
                            compute_dtype=compute_dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = fuse_conv_pair(self.dw, self.pw, x)
        if y is not None:
            return y
        return self.pw(self.dw(x))
