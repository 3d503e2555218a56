"""PyTorch port, checkpoint and resume (`checkpoint.py`) on the CPU:

- FastSCNN at test size, trained through `train_input_pipeline` with its
  dropout and augmentation generators: 2 steps, an asynchronous save,
  a restore into a fresh model, optimizer, schedule and generators, and 2
  more steps from the loader's `start_batch=2` equal 4 uninterrupted steps
  bit for bit (parameters, BN statistics, momentum, LR, generators);
- the port's and the JAX package's `CheckpointManager` (orbax) take the
  same sequence of `save(step, ..., force=...)` calls with the same
  `save_interval_steps` and `max_to_keep`, and keep the same steps with the
  same `latest_step()`;
- an asynchronous save taken before an in-place step holds the pre-step
  values;
- `restore_model` raises, naming the key, on a wrong model."""

import copy
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_semantic_segmentation_tpu.checkpoint import (
    CheckpointManager as JaxCheckpointManager)
from torch_semantic_segmentation_tpu.train import TrainState as JaxTrainState
from torch_semantic_segmentation_tpu_torch.checkpoint import (
    FILE, CheckpointManager)
from torch_semantic_segmentation_tpu_torch.data.pipeline import (
    train_input_pipeline)
from torch_semantic_segmentation_tpu_torch.data.synthetic import ShapesDataset
from torch_semantic_segmentation_tpu_torch.data.transforms import (
    AugmentConfig)
from torch_semantic_segmentation_tpu_torch.models import get_model
from torch_semantic_segmentation_tpu_torch.train import (
    OptimizerConfig, create_train_state, make_train_step)

torch.set_num_threads(2)

DATA = ShapesDataset(8, 80, 96, seed=3)
CFG = AugmentConfig(crop=(64, 64))
OPT = OptimizerConfig(lr=0.05, max_steps=10)


def _run(seed: int):
    """A fresh FastSCNN (5 classes, dropout on), its SGD state and step,
    and the augmentation generator."""
    model = get_model("fastscnn", 5, seed=seed, device="cpu")
    assert model.dropout_generator is not None
    state = create_train_state(model, OPT)
    step = make_train_step(model, state, device="cpu")
    return model, state, step, torch.Generator().manual_seed(100 + seed)


def _steps(step, gen, start: int, count: int):
    pipe = train_input_pipeline(DATA, 2, CFG, generator=gen, device="cpu",
                                seed=7, num_threads=2, start_batch=start)
    for _, (images, labels) in zip(range(count), pipe):
        step(images, labels)


def _momenta(state):
    opt = state.optimizer
    return [opt.state[p]["momentum_buffer"]
            for g in opt.param_groups for p in g["params"]]


def _assert_same_run(a, b):
    (ma, sa, ga), (mb, sb, gb) = a, b
    sda, sdb = ma.state_dict(), mb.state_dict()
    assert list(sda) == list(sdb)
    for k in sda:
        assert torch.equal(sda[k], sdb[k]), k
    for x, y in zip(_momenta(sa), _momenta(sb), strict=True):
        assert torch.equal(x, y)
    assert sa.scheduler.get_last_lr() == sb.scheduler.get_last_lr()
    assert sa.scheduler.last_epoch == sb.scheduler.last_epoch
    assert torch.equal(ga.get_state(), gb.get_state())
    assert torch.equal(ma.dropout_generator.get_state(),
                       mb.dropout_generator.get_state())


def test_two_plus_two_steps_equal_four_bit_for_bit(tmp_path):
    model, state, step, gen = _run(0)
    _steps(step, gen, 0, 4)

    first, first_state, first_step, first_gen = _run(0)
    _steps(first_step, first_gen, 0, 2)
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=1000)
    assert mgr.save(2, first, first_state, force=True,
                    generators=(first_gen, first.dropout_generator))
    mgr.close()

    fresh, fresh_state, fresh_step, fresh_gen = _run(1)
    again = CheckpointManager(str(tmp_path))
    assert again.latest_step() == 2
    assert again.restore_latest(
        fresh, fresh_state,
        generators=(fresh_gen, fresh.dropout_generator)) == 2
    _assert_same_run((fresh, fresh_state, fresh_gen),
                     (first, first_state, first_gen))
    _steps(fresh_step, fresh_gen, 2, 2)
    _assert_same_run((fresh, fresh_state, fresh_gen), (model, state, gen))
    assert fresh_state.scheduler.last_epoch == 4


def _jax_state(v: float):
    return JaxTrainState(params={"w": jnp.full((3,), v)},
                         rest={"mean": jnp.full((2,), v)},
                         opt_state={"m": jnp.full((3,), v)},
                         step=jnp.asarray(int(v)))


# (step, force): in order, skipped and forced saves, an interval hit, a
# step at or below the latest
SAVES = [(0, False), (1, False), (2, False), (3, False), (4, True),
         (5, False), (6, False), (7, False), (9, True), (8, False),
         (12, False), (13, True), (15, False)]


@pytest.mark.parametrize("interval,keep", [(3, 2), (1, 3), (4, 10)])
def test_save_policy_and_pruning_equal_orbax(tmp_path, interval, keep):
    model = torch.nn.Linear(3, 2)
    state = OPT.make(model.parameters())
    port = CheckpointManager(str(tmp_path / "port"), max_to_keep=keep,
                             save_interval_steps=interval)
    ref = JaxCheckpointManager(str(tmp_path / "jax"), max_to_keep=keep,
                               save_interval_steps=interval)
    assert port.latest_step() is None and ref.latest_step() is None
    for step, force in SAVES:
        assert port.save(step, model, state, force=force) == ref.save(
            step, _jax_state(step), force=force), (step, force)
        assert port.latest_step() == ref.latest_step()
    port.wait()
    ref.wait()
    kept = sorted(int(d) for d in os.listdir(tmp_path / "port"))
    assert kept == port.all_steps() == sorted(ref._mgr.all_steps())
    assert port.latest_step() == ref.latest_step()
    with pytest.raises(ValueError, match="already exists"):
        port.save(port.latest_step(), model, state, force=True)
    port.close()
    ref.close()
    reopened = CheckpointManager(str(tmp_path / "port"), max_to_keep=keep,
                                 save_interval_steps=interval)
    assert reopened.all_steps() == kept


def test_async_save_holds_the_values_before_an_in_place_step(tmp_path,
                                                            monkeypatch):
    model, state, step, gen = _run(2)
    _steps(step, gen, 0, 1)
    before = copy.deepcopy(model.state_dict())
    momenta = [m.clone() for m in _momenta(state)]
    lr = state.scheduler.get_last_lr()
    gen_state = gen.get_state()
    mgr = CheckpointManager(str(tmp_path))
    gate = threading.Event()
    real_save = torch.save

    def held_save(*args, **kwargs):   # the write waits for the step
        assert gate.wait(timeout=60)
        return real_save(*args, **kwargs)

    monkeypatch.setattr(torch, "save", held_save)
    assert mgr.save(1, model, state, generators=(gen,), force=True)
    _steps(step, gen, 1, 1)       # in place, before the write
    gate.set()
    assert not torch.equal(before["classifier.conv.weight"],
                           model.state_dict()["classifier.conv.weight"])
    saved = mgr.load(1)
    assert saved["step"] == 1
    for k, v in before.items():
        assert torch.equal(saved["model"][k], v), k
    saved_momenta = [saved["optimizer"]["state"][i]["momentum_buffer"]
                     for i in range(len(momenta))]
    for x, y in zip(saved_momenta, momenta, strict=True):
        assert torch.equal(x, y)
    assert saved["scheduler"]["_last_lr"] == lr
    assert torch.equal(saved["generators"][0], gen_state)
    assert os.listdir(tmp_path) == ["1"]
    assert os.listdir(tmp_path / "1") == [FILE]
    mgr.close()


def test_restore_model_raises_on_a_wrong_model(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.restore_model(get_model("fastscnn", 5, device="cpu")) is None
    model, state, _, _ = _run(0)
    mgr.save(0, model, state)
    other = get_model("fastscnn", 5, seed=9, device="cpu")
    assert mgr.restore_model(other) == 0
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v)
    with pytest.raises(ValueError, match="'classifier.conv.weight' has shape"):
        mgr.restore_model(get_model("fastscnn", 7, device="cpu"))
    with pytest.raises(KeyError, match="has no 'initial"):
        mgr.restore_model(get_model("enet", 5, device="cpu"))
    with pytest.raises(KeyError, match="has no 'aux_lds.conv.conv.weight'"):
        mgr.restore_model(get_model("fastscnn", 5, aux=True, device="cpu"))
    with pytest.raises(ValueError, match="generator states"):
        mgr.restore_latest(model, state, generators=(torch.Generator(),))
    mgr.close()
    with_aux = CheckpointManager(str(tmp_path / "aux"))
    aux = get_model("fastscnn", 5, aux=True, device="cpu")
    with_aux.save(0, aux, create_train_state(aux, OPT))
    with pytest.raises(KeyError, match="keys the model lacks, e.g. 'aux_lds"):
        with_aux.restore_model(model)
    with_aux.close()
