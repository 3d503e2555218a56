"""Inference-time BatchNorm folding.

For every ConvBNAct, the eval-mode BN's affine transform goes into the conv:

    scale = γ / √(σ² + ε)
    W'    = W · scale   (per output channel)
    b'    = β + (b − μ) · scale

A conv without a bias gets one, and `bn` becomes None. The model must be in
eval mode.
"""

from __future__ import annotations

import torch
from torch import nn

from torch_semantic_segmentation_tpu_torch.ops.conv import ConvBNAct


@torch.no_grad()
def fold_conv_bn_act(block: ConvBNAct) -> bool:
    """Fold one ConvBNAct in place. Returns False if already folded."""
    if block.bn is None:
        return False
    bn, conv = block.bn, block.conv
    if bn.training:
        raise ValueError("call model.eval() before folding BatchNorm")
    scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    conv.weight.mul_(scale.view(-1, 1, 1, 1))
    bias = conv.bias if conv.bias is not None else 0.0
    new_bias = bn.bias + (bias - bn.running_mean) * scale
    if conv.bias is not None:
        conv.bias.copy_(new_bias)
    else:
        conv.bias = nn.Parameter(new_bias)
    block.bn = None
    return True


def fold_batchnorm(model: nn.Module) -> int:
    """Fold every ConvBNAct in the tree; returns the folded-block count."""
    blocks = [m for m in model.modules() if isinstance(m, ConvBNAct)]
    return sum(fold_conv_bn_act(m) for m in blocks)
