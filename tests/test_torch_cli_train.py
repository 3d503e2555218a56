"""PyTorch port, the train CLI (`cli/train.py`) on the CPU, FastSCNN at
2x64x128 in float32 (`--device cpu --no-bf16 --dataset synthetic`):

- 3 steps of the CLI equal, bit for bit, a hand-written loop of
  `train_input_pipeline` + `make_train_step` with the same seeds (the
  parameters, BN statistics, momentum, LR and both generators);
- 3 steps, then 2 more with `--resume`, equal 5 uninterrupted steps bit for
  bit (`--schedule-steps 5` in all three runs), as the JAX package's
  `tests/test_cli.py::test_resume_is_bit_identical_to_uninterrupted`;
- SIGTERM during step 3 forces a checkpoint at step 3 and a clean exit,
  the previous handler is put back, and `--resume` to step 5 equals the
  uninterrupted run (the JAX package's
  `test_train_cli_sigterm_saves_and_resumes`);
- `--eval-every` keeps the best checkpoint in `<dir>/best` and prints the
  `it N val mIoU X` line that `scripts/make_accuracy_artifact.py` reads;
  `--logdir` writes the five scalar tags, and raises naming tensorboard
  where the package is missing;
- `--pretrained x.pth` imports the file's weights."""

import os
import re
import signal
import sys

import numpy as np
import pytest
import torch

from torch_semantic_segmentation_tpu_torch import train as ttrain
from torch_semantic_segmentation_tpu_torch.cli.train import main
from torch_semantic_segmentation_tpu_torch.data.pipeline import (
    train_input_pipeline)
from torch_semantic_segmentation_tpu_torch.data.synthetic import (
    synthetic_uint8_batch)
from torch_semantic_segmentation_tpu_torch.data.transforms import (
    AugmentConfig)
from torch_semantic_segmentation_tpu_torch.losses import cross_entropy_loss
from torch_semantic_segmentation_tpu_torch.models import get_model

torch.set_num_threads(2)

BASE = ["--device", "cpu", "--no-bf16", "--dataset", "synthetic",
        "--model", "fastscnn", "--batch-size", "2", "--crop-size", "64",
        "128", "--log-every", "1"]


def _momenta(state):
    opt = state.optimizer
    return [opt.state[p]["momentum_buffer"]
            for g in opt.param_groups for p in g["params"]]


def _assert_same(a, b):
    """Two runs' (model, state, generators) equal bit for bit."""
    (ma, sa, ga), (mb, sb, gb) = a, b
    sda, sdb = ma.state_dict(), mb.state_dict()
    assert list(sda) == list(sdb)
    for k in sda:
        assert torch.equal(sda[k], sdb[k]), k
    for x, y in zip(_momenta(sa), _momenta(sb), strict=True):
        assert torch.equal(x, y)
    assert sa.scheduler.state_dict() == sb.scheduler.state_dict()
    assert len(ga) == len(gb) == 2
    for x, y in zip(ga, gb):
        assert torch.equal(x.get_state(), y.get_state())


def _run(r):
    return r.model, r.state, r.generators


def test_cli_steps_equal_the_library_loop():
    got = main(BASE + ["--max-iterations", "3"])
    assert got.step == 3 and got.best_miou is None

    # the same run by hand: the synthetic bundle (2 x batch frames at the
    # crop), the model from --seed, SGD at the CLI's defaults, the
    # augmentation generator from --seed + 1, the loader from --seed
    images, labels = synthetic_uint8_batch(8, 64, 128, 19, seed=0)
    dataset = list(zip(images, labels))
    model = get_model("fastscnn", 19, seed=0, device="cpu")
    state = ttrain.create_train_state(model, ttrain.OptimizerConfig(
        lr=0.045, momentum=0.9, weight_decay=1e-4, power=0.9, max_steps=3))
    step = ttrain.make_train_step(model, state, cross_entropy_loss,
                                  device="cpu")
    gen = torch.Generator().manual_seed(1)
    cfg = AugmentConfig(crop=(64, 128), scale_range=(0.5, 2.0))
    pipe = train_input_pipeline(dataset, 2, cfg, generator=gen,
                                device="cpu", seed=0)
    for _, (x, y) in zip(range(3), pipe):
        step(x, y)
    _assert_same(_run(got), (model, state, (gen, model.dropout_generator)))


def test_resume_equals_the_uninterrupted_run(tmp_path):
    base = BASE + ["--schedule-steps", "5"]
    straight = main(base + ["--max-iterations", "5"])
    ckpt = str(tmp_path / "ck")
    first = main(base + ["--max-iterations", "3", "--checkpoint-dir", ckpt,
                         "--checkpoint-every", "1"])
    assert first.step == 3
    resumed = main(base + ["--max-iterations", "5", "--checkpoint-dir", ckpt,
                           "--resume"])
    assert resumed.step == 5
    # max_to_keep 3; the resumed run (every 1000) saves only its last step
    assert sorted(os.listdir(ckpt)) == ["2", "3", "5"]
    _assert_same(_run(resumed), _run(straight))


def test_sigterm_saves_and_resumes(tmp_path, monkeypatch, capsys):
    """The signal lands inside step 3 (sent by the step itself, so the run
    is deterministic): the loop saves step 3, exits, and restores the
    previous handler; the resumed run equals the uninterrupted one."""
    base = BASE + ["--schedule-steps", "5"]
    straight = main(base + ["--max-iterations", "5"])

    real = ttrain.make_train_step

    def signalling_step(*args, **kwargs):
        inner = real(*args, **kwargs)
        calls = []

        def step(images, labels):
            calls.append(1)
            if len(calls) == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            return inner(images, labels)
        return step

    monkeypatch.setattr(ttrain, "make_train_step", signalling_step)
    seen = []

    def handler(*args):
        seen.append(args)

    outer = signal.signal(signal.SIGTERM, handler)
    ckpt = str(tmp_path / "ck")
    try:
        stopped = main(base + ["--max-iterations", "100000",
                               "--checkpoint-dir", ckpt,
                               "--checkpoint-every", "1000000"])
        # the CLI's hook took the signal, and put this handler back
        assert not seen
        assert signal.getsignal(signal.SIGTERM) is handler
    finally:
        signal.signal(signal.SIGTERM, outer)
    assert stopped.step == 3
    assert "SIGTERM: checkpoint saved at it 3" in capsys.readouterr().out
    # the first step saves (no checkpoint yet), then only the forced one
    assert sorted(os.listdir(ckpt)) == ["1", "3"]
    monkeypatch.setattr(ttrain, "make_train_step", real)
    resumed = main(base + ["--max-iterations", "5", "--checkpoint-dir", ckpt,
                           "--resume"])
    _assert_same(_run(resumed), _run(straight))


def test_eval_every_keeps_the_best_and_logdir_writes_the_tags(tmp_path,
                                                              capsys):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)

    ckpt, logdir = str(tmp_path / "ck"), str(tmp_path / "tb")
    run = main(BASE + ["--max-iterations", "4", "--eval-every", "2",
                       "--eval-batches", "1", "--checkpoint-dir", ckpt,
                       "--logdir", logdir])
    out = capsys.readouterr().out
    curve = [(int(m.group(1)), float(m.group(2)))
             for m in re.finditer(r"it (\d+) val mIoU ([\d.]+)", out)]
    assert [s for s, _ in curve] == [2, 4]
    best = max(v for _, v in curve)
    assert run.best_miou is not None
    assert f"{100 * run.best_miou:.2f}" == f"{best:.2f}"
    assert f"best val mIoU {best:.2f}" in out
    steps = os.listdir(os.path.join(ckpt, "best"))
    assert len(steps) == 1 and steps[0] in {str(s) for s, v in curve
                                             if v == best}

    acc = EventAccumulator(logdir)
    acc.Reload()
    tags = set(acc.Tags()["scalars"])
    assert {"train/loss", "train/images_per_sec_per_chip", "train/lr",
            "val/miou", "val/iou/road"} <= tags
    assert len([t for t in tags if t.startswith("val/iou/")]) == 19
    lrs = [e.value for e in acc.Scalars("train/lr")]
    np.testing.assert_allclose(
        lrs, [0.045 * (1 - t / 4) ** 0.9 for t in range(4)], rtol=1e-6)
    assert [e.step for e in acc.Scalars("val/miou")] == [2, 4]


def test_logdir_without_tensorboard_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(RuntimeError, match="tensorboard"):
        main(BASE + ["--max-iterations", "1", "--logdir", "unused"])


def test_pretrained_imports_the_weights(tmp_path, capsys):
    source = get_model("fastscnn", 19, seed=7, device="cpu")
    path = str(tmp_path / "x.pth")
    torch.save(source.state_dict(), path)
    run = main(BASE + ["--max-iterations", "1", "--lr", "0",
                       "--pretrained", path])
    assert f"imported torch checkpoint {path}" in capsys.readouterr().out
    # lr 0: the update leaves every parameter as imported; the train-mode
    # step moves only the BN statistics
    want = dict(source.named_parameters())
    for name, p in run.model.named_parameters():
        assert torch.equal(p.detach(), want[name].detach()), name
    fresh = get_model("fastscnn", 19, seed=0, device="cpu")
    assert not torch.equal(next(fresh.parameters()),
                           next(run.model.parameters()))
