"""Inverted residual, pyramid pooling and segmentation-head blocks, NHWC."""

from __future__ import annotations

import torch
from torch import nn

from torch_semantic_segmentation_tpu_torch.ops.conv import (
    ConvBNAct, activation, make_conv)
from torch_semantic_segmentation_tpu_torch.ops import mbconv
from torch_semantic_segmentation_tpu_torch.ops.dropout import Dropout
from torch_semantic_segmentation_tpu_torch.ops.folded_bn import (
    folded_1x1_weights)
from torch_semantic_segmentation_tpu_torch.ops.mbconv import fused_expand_dw
from torch_semantic_segmentation_tpu_torch.ops.pool import adaptive_avg_pool2d
from torch_semantic_segmentation_tpu_torch.ops.upsample import resize_bilinear


class InvertedResidual(nn.Module):
    """MobileNetV2 inverted residual: expand 1×1 → depthwise 3×3 → project
    1×1, with the residual add when stride is 1 and in_ch == out_ch."""

    def __init__(self, in_ch: int, out_ch: int, *, stride: int = 1,
                 expand_ratio: int = 6,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        hidden = in_ch * expand_ratio
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        self.use_res = stride == 1 and in_ch == out_ch
        self.expand = ConvBNAct(in_ch, hidden, 1, act="relu", **kw)
        self.dw = ConvBNAct(hidden, hidden, 3, stride=stride, groups=hidden,
                            act="relu", **kw)
        self.project = ConvBNAct(hidden, out_ch, 1, act=None, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._maybe_fused_expand_dw(x)
        if y is None:
            y = self.dw(self.expand(x))
        y = self.project(y)
        return x + y if self.use_res else y

    def _maybe_fused_expand_dw(self, x: torch.Tensor) -> torch.Tensor | None:
        """Training-mode expand (1×1, BN folded from the input's moments by
        `ops.folded_bn`) → ReLU → depthwise 3×3 as one fused op
        (`ops.mbconv`, the Hopper kernel K2): the expanded tensor, the
        largest activation of the network, never reaches device memory.
        Returns the dw output after the dw BN and ReLU, or None where the
        block does not qualify: eval mode, another conv shape, a compute
        dtype other than bf16, or inside `mbconv.suppress_routing()`."""
        exp, dw = self.expand, self.dw
        if (mbconv.routing_suppressed() or not self.training
                or exp.bn is None or dw.bn is None
                or not exp.bn.training or not dw.bn.training):
            return None
        if exp.act_name != "relu":
            return None
        ec, dc = exp.conv, dw.conv
        hidden = ec.out_channels
        if (ec.kernel_size != (1, 1) or ec.groups != 1
                or ec.stride != (1, 1) or ec.padding != (0, 0)):
            return None
        if (dc.kernel_size != (3, 3) or dc.groups != hidden
                or dc.in_channels != hidden or dc.bias is not None
                or dc.dilation != (1, 1) or dc.padding != (1, 1)
                or dc.stride not in ((1, 1), (2, 2))):
            return None
        # the kernel computes in bf16: route only where the plain dw conv's
        # output would be bf16 too
        dw_dtype = dc.compute_dtype or torch.promote_types(x.dtype,
                                                           dc.weight.dtype)
        if x.dtype != torch.bfloat16 or dw_dtype != torch.bfloat16:
            return None
        w_fold, b_fold = folded_1x1_weights(ec, exp.bn, x)
        k = dc.weight.reshape(hidden, 3, 3).permute(1, 2, 0)
        y = fused_expand_dw(x.contiguous(), w_fold, b_fold, k, dc.stride[0])
        return activation(dw.act_name)(dw.bn(y))


class PyramidPooling(nn.Module):
    """PSPNet pyramid pooling: per bin, adaptive-avg-pool → 1×1 conv-BN-ReLU
    → bilinear upsample back; concat with the input → 1×1 fuse conv."""

    def __init__(self, in_ch: int, out_ch: int, *, bins=(1, 2, 3, 6),
                 align_corners: bool = False,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        self.bins = tuple(bins)
        self.align_corners = align_corners
        branch_ch = in_ch // len(self.bins)
        self.branches = nn.ModuleList([
            ConvBNAct(in_ch, branch_ch, 1, act="relu", **kw)
            for _ in self.bins])
        self.fuse = ConvBNAct(in_ch + branch_ch * len(self.bins), out_ch, 1,
                              act="relu", **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        feats = [x]
        for b, conv in zip(self.bins, self.branches):
            y = conv(adaptive_avg_pool2d(x, b))
            feats.append(resize_bilinear(y, (h, w),
                                         align_corners=self.align_corners))
        return self.fuse(torch.cat(feats, dim=-1))


class SegHead(nn.Module):
    """3×3 conv-BN-ReLU → dropout → 1×1 logits (FastSCNN's aux heads).
    `generator` draws the initial weights; `dropout_generator`, on the
    model's device, draws the train-mode dropout masks."""

    def __init__(self, in_ch: int, mid_ch: int, num_classes: int, *,
                 dropout: float = 0.1,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None,
                 dropout_generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        self.conv = ConvBNAct(in_ch, mid_ch, 3, act="relu", **kw)
        self.dropout = (Dropout(dropout, generator=dropout_generator)
                        if dropout > 0 else None)
        self.classifier = make_conv(mid_ch, num_classes, 1, use_bias=True,
                                    **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.dropout is not None:
            x = self.dropout(x)
        return self.classifier(x)
