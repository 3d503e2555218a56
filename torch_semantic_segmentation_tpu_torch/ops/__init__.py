"""Ops layer of the PyTorch port: NHWC building blocks with the JAX
package's numerics, plus the Hopper kernels that replace its Pallas ones."""

from torch_semantic_segmentation_tpu_torch.ops.conv import (
    ConvBNAct,
    ConvTranspose2d,
    PReLU,
    SeparableConv,
    activation,
    make_conv,
    make_norm,
)
from torch_semantic_segmentation_tpu_torch.ops.pool import (
    adaptive_avg_pool2d,
    avg_pool2d,
    global_avg_pool,
    max_pool2d,
    max_pool2x2_with_indices,
    max_unpool2x2,
)
from torch_semantic_segmentation_tpu_torch.ops.upsample import (
    resize_argmax,
    resize_bilinear,
    resize_bilinear_nhcw,
    resize_nearest,
    upsample2x_bilinear,
)
from torch_semantic_segmentation_tpu_torch.ops.blocks import (
    ASPP,
    InvertedResidual,
    PyramidPooling,
    SegHead,
)

__all__ = [
    "ASPP", "ConvBNAct", "ConvTranspose2d", "InvertedResidual",
    "PReLU", "PyramidPooling", "SegHead", "SeparableConv", "activation",
    "adaptive_avg_pool2d", "avg_pool2d", "global_avg_pool", "make_conv",
    "make_norm", "max_pool2d", "max_pool2x2_with_indices", "max_unpool2x2",
    "resize_argmax", "resize_bilinear", "resize_bilinear_nhcw",
    "resize_nearest", "upsample2x_bilinear",
]
