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

import contextlib
import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from torch_semantic_segmentation_tpu_torch.ops import depthwise
from torch_semantic_segmentation_tpu_torch.ops.sepconv import fuse_conv_pair
from torch_semantic_segmentation_tpu_torch.parallel import distributed

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


# the running-statistics updates held back by `deferred_running_stats`
_deferred: list | None = None


@contextlib.contextmanager
def deferred_running_stats():
    """Within the block BatchNorm's running-statistics updates are held
    back in the list it yields, as (bn, mean, var), for the caller to
    apply (`apply_running_stats`) or drop: the train step keeps its state
    where a check before the update fails, and the recompute of a
    checkpointed segment drops its second update."""
    global _deferred
    outer, _deferred = _deferred, []
    try:
        yield _deferred
    finally:
        _deferred = outer


def apply_running_stats(pending: list) -> None:
    for bn, mean, var in pending:
        bn.update_running_stats(mean, var)


def batch_moments(x: torch.Tensor, dims) -> tuple[torch.Tensor, torch.Tensor]:
    """(E[x], E[x²]) over `dims` of the global batch: the rank's own means,
    and under a process group their weighted sum over ranks in one
    collective that carries gradients. Each rank weighs its share of the
    global batch's pixels (`distributed.pixel_share`: 1/R on equal shares,
    its band's rows over the image's on unequal bands, 1/R for a tensor
    the same on every band); with one rank the weight is 1.0 and the
    result the rank's own, bit for bit."""
    mean = x.mean(dim=dims)
    sq = (x * x).mean(dim=dims)
    if not distributed.is_initialized():
        return mean, sq
    both = distributed.all_reduce_sum(
        torch.stack([mean, sq]) * distributed.pixel_share(x.shape[1]))
    return both[0], both[1]


def band_halo(kernel: int, stride: int, padding: int,
              dilation: int = 1) -> tuple[int, int]:
    """(top, bottom): the halo rows an H-sharded conv of this geometry
    takes from the bands above and below (`distributed.on_band`). The top
    is the padding rounded up to the stride, so that the local grid stays
    the global one (at stride 2 with padding 1, two rows, and the first
    output row is cropped); the bottom covers what the band's last output
    row reads past the band. A 1×1 conv takes none."""
    top = -(-padding // stride) * stride
    bottom = max(0, dilation * (kernel - 1) - padding - stride + 1)
    return top, bottom


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
    """`nn.Conv2d` on NHWC tensors with a call-time compute dtype. On an H
    band the conv runs on band + the halo its geometry takes and is
    cropped to the band's rows (`on_band`), so a conv with kh > 1 pads
    only at the image's global top and bottom; a 1×1 or 1×K conv takes
    no halo and makes no exchange."""

    def __init__(self, *args, compute_dtype: torch.dtype | None = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.on_band(self.local, x)

    def on_band(self, fn, x: torch.Tensor) -> torch.Tensor:
        """`fn`, this conv or a kernel that computes it, of this rank's H
        band: `distributed.on_band` with the halo of the conv's geometry
        (`band_halo`); fn(x) without spatial sharding."""
        return distributed.on_band(
            fn, x, *band_halo(self.kernel_size[0], self.stride[0],
                              self.padding[0], self.dilation[0]),
            down=self.stride[0])

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """The conv of x's rows as they are, with no halo: what `on_band`
        runs on band + halo."""
        dt = _compute_types(x, self.weight, self.compute_dtype)
        bias = self.bias.to(dt) if self.bias is not None else None
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), bias,
                     self.stride, self.padding, self.dilation, self.groups)
        return y.permute(0, 2, 3, 1)


class PReLU(nn.Module):
    """Parametric ReLU with a slope per channel (the last axis), initialised
    to 0.25 as torch's `nn.PReLU`: `where(x >= 0, x, a·x)` with the slope
    cast to x's dtype first, as in the JAX package. At x = 0 the gradient
    is 1 for x and 0 for the slope, where `F.prelu`'s backward takes the
    slope; bf16 activations do reach exact zeros."""

    def __init__(self, num_parameters: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.full((num_parameters,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


class ConvTranspose2d(nn.ConvTranspose2d):
    """`nn.ConvTranspose2d` on NHWC tensors with a call-time compute dtype.
    The weight is torch's (in, out, kh, kw), the layout the JAX package's
    `compat.export_torch_state_dict` writes; both are drawn from
    uniform(±1/√(in·kh·kw)), as the JAX package's `ConvTranspose2d` draws
    them. It runs on ATen/cuDNN: the JAX package left it to XLA. On an H
    band two geometries run: a kernel equal to its stride without padding
    (UNet's 2×2/s2: each input row makes its own `stride` output rows, no
    halo), and the 3×3/s2 with padding 1 and output padding 1 (ENet's and
    ERFNet's upsamplers: output row 2m reads input row m, row 2m+1 rows m
    and m+1, so band rows [a, b) make output rows [2a, 2b) from one bottom
    halo row; at the image's global bottom none arrives and the output
    padding's zero row falls where the single process puts it). Any other
    geometry raises NotImplementedError there."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size, *, stride=1,
                 padding=0, output_padding=0, use_bias: bool = True,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__(in_ch, out_ch, _pair(kernel_size),
                         stride=_pair(stride), padding=_pair(padding),
                         output_padding=_pair(output_padding), bias=use_bias)
        self.compute_dtype = compute_dtype
        kh, kw = _pair(kernel_size)
        bound = 1.0 / (in_ch * kh * kw) ** 0.5
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            if self.bias is not None:
                self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not distributed.is_spatial():
            return self.local(x)
        k, s, p = self.kernel_size[0], self.stride[0], self.padding[0]
        op, d = self.output_padding[0], self.dilation[0]
        if d == 1 and k == s and not p and not op:
            return self.local(x)
        if (k, s, p, op, d) == (3, 2, 1, 1, 1):
            return distributed.on_band(self.local, x, 0, 1, up=2)
        raise NotImplementedError(
            f"a {k}x{self.kernel_size[1]}/s{s} transposed conv with padding "
            f"{p}, output padding {op} and dilation {d} on an H band: "
            "spatial sharding takes a kernel equal to its stride, unpadded "
            "(UNet's 2x2/s2), and the 3x3/s2 with padding 1 and output "
            "padding 1 (ENet's and ERFNet's upsamplers)")

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """The transposed conv of x's rows as they are, with no halo."""
        dt = _compute_types(x, self.weight, self.compute_dtype)
        bias = self.bias.to(dt) if self.bias is not None else None
        y = F.conv_transpose2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt),
                               bias, self.stride, self.padding,
                               self.output_padding)
        return y.permute(0, 2, 3, 1)


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` on NHWC tensors with a call-time compute dtype and
    flax's `nnx.BatchNorm` numerics.

    Training mode (flax's `_compute_stats` and `_normalize`): the batch
    mean and the biased variance E[x²]−E[x]² (clipped at 0) in float32,
    or float64 for a float64 input, over N, H and W (of the global batch
    under a process group: `batch_moments`); the running stats move in
    place as `(1−m)·running + m·batch`; the output is
    `(x − mean)·(rsqrt(var+eps)·scale) + bias` in that type, cast to the
    compute dtype. Gradients flow through the batch statistics. Not
    `nn.SyncBatchNorm`, which keeps the running variance unbiased where
    flax keeps it biased."""

    def __init__(self, *args, compute_dtype: torch.dtype | None = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def update_running_stats(self, mean: torch.Tensor,
                             var: torch.Tensor) -> None:
        """Move the running stats toward a batch's float32 mean and biased
        variance, as flax does with momentum 1−m. `momentum=None` keeps
        torch's cumulative average (m = 1 / batches seen). Inside
        `deferred_running_stats` the update is held back instead."""
        if _deferred is not None:
            _deferred.append((self, mean.detach(), var.detach()))
            return
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
            # flax's statistics are at least float32 (float64 stays so)
            st = torch.promote_types(dt, torch.float32)
            xf = x.to(dt).to(st)
            mean, sq = batch_moments(xf, (0, 1, 2))
            var = torch.clamp(sq - mean * mean, min=0.0)
            self.update_running_stats(mean, var)
            # flax promotes scale and bias to the compute dtype first
            mul = torch.rsqrt(var + self.eps) * self.weight.to(dt).to(st)
            return ((xf - mean) * mul + self.bias.to(dt).to(st)).to(dt)
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
    depthwise 3×3 runs through `ops.depthwise` (the Hopper kernel K6).
    `prelu=True` replaces the activation by a per-channel `PReLU`
    (`act`), whose `act_name` is "prelu"."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size=3, *, stride=1,
                 padding=None, dilation=1, groups: int = 1, act: Act = "relu",
                 use_bias: bool = False, prelu: bool = False,
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
        self.act = PReLU(out_ch) if prelu else None
        self.act_name = "prelu" if prelu else act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # on an H band: the conv (or K6) on band + halo, cropped to the
        # band, so that BN's moments never see a halo row
        rows = distributed.global_rows(x.shape[1])
        y = self.conv.on_band(lambda xh: self._conv(xh, rows), x)
        if self.bn is not None:
            y = self.bn(y)
        if self.act is not None:
            return self.act(y)
        return activation(self.act_name)(y)

    def _conv(self, x: torch.Tensor, rows: int) -> torch.Tensor:
        y = self._maybe_depthwise(x, rows)
        return self.conv.local(x) if y is None else y

    def _maybe_depthwise(self, x: torch.Tensor,
                         rows: int | None = None) -> torch.Tensor | None:
        """The JAX package's `ConvBNAct._maybe_pallas_dw` with its opt-in
        switch on: a depthwise 3×3 (groups = C = the input's channels),
        dilation 1, padding 1, stride 2, no bias, over at least
        `DEPTHWISE_MIN_PX` input pixels, whose compute dtype is x's, goes
        through `ops.depthwise` with the float32 kernel. Returns None where
        the conv does not qualify. Folding BN gives a conv a bias, so the
        serving path never routes here. `rows` is the input's global H
        (x's own by default; a band with its halo counts the image's), so
        that the route does not depend on the spatial split."""
        conv = self.conv
        c = x.shape[-1]
        if (conv.groups == 1 or conv.groups != c or conv.out_channels != c
                or conv.kernel_size != (3, 3) or conv.dilation != (1, 1)
                or conv.stride != (2, 2) or conv.padding != (1, 1)
                or conv.bias is not None):
            return None
        if not depthwise.supports(tuple(x.shape), 2, dtype=x.dtype):
            return None
        if x.shape[0] * (rows or x.shape[1]) * x.shape[2] < DEPTHWISE_MIN_PX:
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
