"""Training-mode BatchNorm of a 1×1 conv, folded into the conv's weights
from the input's first two moments (the JAX package's
`ops/folded_bn.py::folded_1x1_weights`).

For a stride-1, group-1 1×1 conv `e = x·W (+ b)` the batch statistics of
`e` follow from the input alone:

    E[e]     = μx·W + b
    var(e)_j = (Wᵀ·E[x xᵀ]·W)_jj − (μx·W)_j²        (biased, clipped at 0)

so BN folds into the conv as W′ = W·s, b′ = β − E[e]·s (+ b·s) with
s = γ/√(var+ε), and the pre-BN tensor never has to exist. The fused
expand → depthwise kernel (`ops.mbconv`) consumes W′ and b′. This is plain
autograd: gradients reach x, the conv and the BN parameters through the
moment products, as in JAX. Under a process group μx and E[x xᵀ] are the
global batch's, reduced over ranks in one collective with gradients
through it, so every rank folds the same W′ and b′.
"""

from __future__ import annotations

import torch

from torch_semantic_segmentation_tpu_torch.ops.conv import BatchNorm2d, Conv2d
from torch_semantic_segmentation_tpu_torch.parallel import distributed


def folded_1x1_weights(conv: Conv2d, bn: BatchNorm2d, x: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Folded (W′ (Cin,Cout), b′ (Cout,)), both float32, for a training-mode
    1×1 `conv` → `bn` on NHWC `x`. Updates `bn`'s running mean and biased
    running variance in place, as the unfolded BN would."""
    c_out, c_in = conv.weight.shape[0], conv.weight.shape[1]
    wf = conv.weight.reshape(c_out, c_in).t().float()          # (Cin, Cout)

    # the moments in float32: a product of two bf16 values is exact in
    # float32, so this is the JAX package's bf16 einsum with f32 accumulation
    xr = x.reshape(-1, c_in).float()
    second = (xr.t() @ xr) / xr.shape[0]                       # E[x xᵀ]
    mu_x = xr.mean(dim=0)
    if distributed.is_initialized():
        # each rank's moments weigh its share of the batch's pixels
        both = distributed.all_reduce_sum(
            torch.cat([second, mu_x[None]]) * distributed.pixel_share(
                x.shape[1]))
        second, mu_x = both[:c_in], both[c_in]

    mu_lin = mu_x @ wf                                          # E[x·W]
    mu_e = mu_lin
    if conv.bias is not None:
        mu_e = mu_e + conv.bias.float()
    e2 = ((second @ wf) * wf).sum(dim=0)                        # E[(x·W)²]
    var_e = torch.clamp(e2 - mu_lin * mu_lin, min=0.0)
    bn.update_running_stats(mu_e, var_e)

    s = bn.weight.float() * torch.rsqrt(var_e + bn.eps)
    b_fold = bn.bias.float() - mu_e * s
    if conv.bias is not None:
        b_fold = b_fold + conv.bias.float() * s
    return wf * s[None, :], b_fold
