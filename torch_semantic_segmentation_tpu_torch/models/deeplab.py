"""DeepLabV3 (Chen et al. 2017) in PyTorch: a dilated ResNet backbone, ASPP
on its last stage, dropout and a 1×1 classifier, with the JAX package's
module names and attribute paths.

With `upsample_logits=False` the model returns logits at the output stride
(1/16 by default), for `losses.resize_ohem_cross_entropy` or
`losses.resize_cross_entropy_loss`, which upsample inside the loss; with
`aux=True` it also returns an FCN head's logits on the stage-3 features.
Input and output are NHWC, as in the JAX package. Under spatial sharding
they are an H band of the image: each conv and the stem's max pool take
the halo their geometry needs, which past ASPP's rates at 1/16 spans
several bands, and the image-level branch pools over the whole image.
"""

from __future__ import annotations

import torch
from torch import nn

from torch_semantic_segmentation_tpu_torch.device import resolve_device
from torch_semantic_segmentation_tpu_torch.models.resnet import ResNet
from torch_semantic_segmentation_tpu_torch.ops import (
    ASPP, SegHead, make_conv, resize_bilinear)
from torch_semantic_segmentation_tpu_torch.ops.dropout import Dropout


class DeepLabV3(nn.Module):
    """DeepLabV3. Returns (N, H, W, num_classes) logits, or logits at the
    output stride with `upsample_logits=False`; with `aux=True`,
    (main, aux). `generator` draws the initial weights;
    `dropout_generator`, on the device the model runs on, draws every
    train-mode dropout mask. `max_stride` is its deepest map's stride,
    the output stride, for the spatial guards
    (`parallel.shard_batch(spatial=True, max_stride=...)`)."""

    def __init__(self, num_classes: int = 19, *, depth: int = 50, output_stride: int = 16,
                 aspp_channels: int = 256, aux: bool = False,
                 align_corners: bool = False, upsample_logits: bool = True,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None,
                 dropout_generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        self.dropout_generator = dropout_generator
        self.aux = aux
        self.align_corners = align_corners
        self.upsample_logits = upsample_logits
        self.max_stride = output_stride
        self.backbone = ResNet(depth, output_stride=output_stride, **kw)
        # the ASPP rates double at output stride 8 (DeepLabV3 §4.2)
        rates = (12, 24, 36) if output_stride == 8 else (6, 12, 18)
        self.aspp = ASPP(self.backbone.out_channels, aspp_channels,
                         rates=rates, **kw)
        self.dropout = Dropout(0.1, generator=dropout_generator)
        self.classifier = make_conv(aspp_channels, num_classes, 1,
                                    use_bias=True, **kw)
        if aux:
            self.aux_head = SegHead(self.backbone.c3_channels,
                                    aspp_channels // 2, num_classes,
                                    dropout_generator=dropout_generator, **kw)

    def remat_segments(self) -> list[nn.Module]:
        """The modules a rematerialised train step checkpoints one by one
        (`train.make_train_step(remat=True)`): the backbone's stem and
        four stages, the ASPP, the classifier and the aux head."""
        b = self.backbone
        heads = [self.aux_head] if self.aux else []
        return [b.stem, b.stage1, b.stage2, b.stage3, b.stage4, self.aspp,
                self.classifier, *heads]

    def forward(self, x: torch.Tensor):
        h, w = x.shape[1], x.shape[2]
        _, _, c3, c4 = self.backbone(x)
        y = self.classifier(self.dropout(self.aspp(c4)))
        if self.upsample_logits:
            y = resize_bilinear(y, (h, w), align_corners=self.align_corners)
        if self.aux:
            return y, self.aux_head(c3)
        return y


def _make(depth: int):
    def ctor(num_classes: int = 19, *, output_stride: int = 16,
             aux: bool = False, upsample_logits: bool = True,
             align_corners: bool = False,
             compute_dtype: torch.dtype | None = None, seed: int = 0,
             device: str | torch.device | None = None) -> DeepLabV3:
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        drop_gen = torch.Generator(device=dev).manual_seed(seed)
        model = DeepLabV3(num_classes, depth=depth,
                          output_stride=output_stride, aux=aux,
                          align_corners=align_corners,
                          upsample_logits=upsample_logits,
                          compute_dtype=compute_dtype, generator=gen,
                          dropout_generator=drop_gen)
        return model.to(dev)

    ctor.__name__ = f"deeplabv3_resnet{depth}"
    ctor.__doc__ = (f"DeepLabV3 on a dilated ResNet-{depth}, float32 "
                    "parameters drawn from `torch.Generator().manual_seed"
                    "(seed)`, on `device` (the card unless the caller passes "
                    "\"cpu\"); its dropout masks come from a generator on "
                    "that device, seeded with `seed`.")
    return ctor


deeplabv3_resnet18 = _make(18)
deeplabv3_resnet34 = _make(34)
deeplabv3_resnet50 = _make(50)
deeplabv3_resnet101 = _make(101)
