"""PyTorch port, the train CLI's `--multihost` on the CPU: two gloo ranks
(`tests/torch_mp_worker.py`, suite "cli") run `cli.train.main` with
`--multihost --device cpu` (FastSCNN, float32, synthetic data, global
batch 4 of 64x128 crops, LR 0.002), against this process running the same
flags without `--multihost`, as the JAX package's
tests/test_multiprocess.py holds its two processes against one:

- the per-step losses: the same on both ranks, and the single run's at
  the JAX package's bars (`test_multihost_train_cli_matches_single_process`):
  step 1 at atol 1.1e-6, the later steps, where SGD amplifies the
  reordered float32 sums, at atol 2e-3 (reading 1.7e-4 at step 4);
- `--eval-every`: both ranks get the same val mIoU, and the single run's
  within 1e-4 (reading 7.7e-8: the parameters differ in float32 noise, so
  a pixel's argmax may flip);
- `--checkpoint-dir`: 2 steps, then 2 more with `--resume`, equal 4
  uninterrupted steps bit for bit (the parameters, the BN statistics and
  the logged losses), and rank 0 alone wrote the checkpoints (steps 1, 2 and 4: the
  first step is saved where none exists, as orbax's policy does);
- a `--batch-size` that does not divide by the ranks raises."""

import os

import numpy as np
import pytest
import torch

import torch_mp_worker as w
from torch_semantic_segmentation_tpu_torch.cli.train import main

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("cli"))
    procs = w.launch("cli", out, world=2)
    single = w.cli_result(main(w.cli_flags() + [
        "--max-iterations", "4", "--eval-every", "4", "--eval-batches", "2"]))
    return w.collect(procs, out), single, out


def test_multihost_losses_equal_the_single_process(runs, capsys):
    ranks, single, _ = runs
    assert single["steps"].tolist() == [1, 2, 3, 4]
    for r in ranks:
        got = r["eval"]
        assert got["steps"].tolist() == [1, 2, 3, 4]
        assert torch.equal(got["losses"], ranks[0]["eval"]["losses"])
        np.testing.assert_allclose(got["losses"][0], single["losses"][0],
                                   rtol=0, atol=1.1e-6)
        np.testing.assert_allclose(got["losses"][1:].numpy(),
                                   single["losses"][1:].numpy(), rtol=0,
                                   atol=2e-3)


def test_eval_every_gives_every_rank_the_single_miou(runs):
    ranks, single, _ = runs
    want = float(single["best_miou"])
    assert np.isfinite(want) and want > 0
    for r in ranks:
        assert float(r["eval"]["best_miou"]) == float(
            ranks[0]["eval"]["best_miou"])
        assert abs(float(r["eval"]["best_miou"]) - want) <= 1e-4


def test_resume_equals_the_uninterrupted_run_and_rank0_writes(runs):
    ranks, _, out = runs
    for r in ranks:
        got, want = r["resumed"], r["eval"]
        assert got["steps"].tolist() == [3, 4]
        assert torch.equal(got["losses"], want["losses"][2:])
        for k, v in want["state"].items():
            assert torch.equal(got["state"][k], v), k
    assert ranks[0]["writes"].tolist() == [1, 2, 4]
    assert ranks[1]["writes"].tolist() == []
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["1", "2", "4"]


def test_indivisible_batch_raises(runs):
    for r in runs[0]:
        assert "not divisible by 2 processes" in r["indivisible"]
