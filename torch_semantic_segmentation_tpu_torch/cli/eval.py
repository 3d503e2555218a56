"""Evaluation CLI of the port (the JAX package's `cli/eval.py`):
confusion-matrix mIoU over a validation split, single or multi-scale
(+flip).

  python -m torch_semantic_segmentation_tpu_torch.cli.eval \
      --model bisenet --dataset cityscapes --dataset-dir /data/cityscapes \
      --checkpoint ckpts --multi-scale

--checkpoint accepts a checkpoint directory of the port's train CLI or a
torch .pth/.pt file (reference weights through the compat loader).
"""

from __future__ import annotations

import argparse

from torch import nn


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="fastscnn")
    p.add_argument("--dataset", default="cityscapes",
                   choices=["cityscapes", "camvid", "bdd", "mapillary",
                            "synthetic", "shapes"])
    p.add_argument("--dataset-dir", default=None)
    p.add_argument("--split", default="val")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint dir or torch .pth (optional: random "
                        "init)")
    p.add_argument("--multi-scale", action="store_true")
    p.add_argument("--scales", type=float, nargs="+",
                   default=[0.5, 0.75, 1.0, 1.25, 1.5, 1.75])
    p.add_argument("--no-flip", dest="flip", action="store_false")
    p.add_argument("--eval-size", type=int, nargs=2, default=None,
                   help="resize eval inputs to H W (defaults to native)")
    p.add_argument("--max-batches", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; raises "
                        "when there is none). Pass cpu for the CPU")
    return p.parse_args(argv)


def load_weights(model: nn.Module, checkpoint: str | None):
    """Load `checkpoint` into `model` in place: a `.pth`/`.pt` file through
    the compat loader, anything else as a checkpoint directory of the train
    CLI (the model's state only: parameters and BN statistics). Nothing
    for None."""
    if not checkpoint:
        return
    if checkpoint.endswith((".pth", ".pt")):
        from torch_semantic_segmentation_tpu_torch.compat.torch_loader import (
            load_torch_checkpoint)
        load_torch_checkpoint(model, checkpoint)
        print(f"imported torch checkpoint {checkpoint}")
        return
    from torch_semantic_segmentation_tpu_torch.checkpoint import (
        CheckpointManager)
    step = CheckpointManager(checkpoint).restore_model(model)
    if step is None:
        raise FileNotFoundError(f"no checkpoint found in {checkpoint}")
    print(f"restored step-{step} checkpoint from {checkpoint}")


def main(argv=None):
    from torch_semantic_segmentation_tpu_torch.cli.common import (
        build_dataset, val_batches)
    from torch_semantic_segmentation_tpu_torch.device import resolve_device
    from torch_semantic_segmentation_tpu_torch.eval import (
        evaluate, make_multiscale_eval_step)
    from torch_semantic_segmentation_tpu_torch.models import get_model
    from torch_semantic_segmentation_tpu_torch.train import make_eval_step

    args = parse_args(argv)
    dev = resolve_device(args.device)
    bundle = build_dataset(args.dataset, args.dataset_dir, args.split)
    model = get_model(args.model, num_classes=bundle.num_classes, seed=0,
                      device=dev)
    load_weights(model, args.checkpoint)

    if args.multi_scale:
        ev = make_multiscale_eval_step(
            model, num_classes=bundle.num_classes,
            scales=tuple(args.scales), flip=args.flip,
            ignore_index=bundle.ignore_index, device=dev)
    else:
        ev = make_eval_step(model, num_classes=bundle.num_classes,
                            ignore_index=bundle.ignore_index, device=dev)

    batches = val_batches(bundle, args.batch_size, device=dev,
                          max_batches=args.max_batches,
                          eval_size=args.eval_size)
    iou, miou, _ = evaluate(ev, batches, num_classes=bundle.num_classes,
                            device=dev)
    for name, v in zip(bundle.class_names, iou):
        print(f"{name:>16s}  {100 * v:6.2f}")
    print(f"{'mIoU':>16s}  {100 * miou:6.2f}")
    return iou, miou


def cli() -> int:
    """Console-script entry point (pyproject [project.scripts]): discard
    main()'s programmatic return value so setuptools' sys.exit() sees 0."""
    main()
    return 0


if __name__ == "__main__":
    main()
