"""PyTorch port, `profiling.py` and `debug.py` on the CPU, beside the JAX
package's tests/test_aux_subsystems.py:

- `cost_analysis` of a 128x128 matmul counts at least 2·128³·0.9 flops, as
  the JAX package's does; of a FastSCNN train step, flops, bytes and
  transcendentals (the kernels' plain versions are ATen operations here)
  and no kernel launches;
- `measure` gives a finite positive time; `trace` writes a Chrome trace
  naming the operations; `memory_stats()` is None on the CPU;
- `enable_nan_debugging` names `aten::log` at log(0), the backward's
  operation (and anomaly mode its backward function) that makes the first
  infinity, and a kernel's non-finite output;
  off again, log(0) is -inf;
- `checked_step` raises where the JAX package's `checked_step` raises on
  the same inputs, and on the port's train step a NaN pixel raises and
  leaves the state dict, the momentum and the schedule bit for bit, a
  NaN that reaches the gradients and not the loss raises too, and a
  finite checked step equals the unchecked one bit for bit."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_semantic_segmentation_tpu import debug as jdebug
from torch_semantic_segmentation_tpu_torch import debug, kernels, profiling
from torch_semantic_segmentation_tpu_torch.losses import (
    resize_cross_entropy_loss)
from torch_semantic_segmentation_tpu_torch.models import fastscnn
from torch_semantic_segmentation_tpu_torch.train import (
    OptimizerConfig, create_train_state, make_train_step)

torch.set_num_threads(2)


def _step():
    model = fastscnn(19, upsample_logits=False, device="cpu")
    state = create_train_state(model, OptimizerConfig(lr=0.01, max_steps=4))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 64, 128, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 19, (2, 64, 128)).astype(np.int32))
    return model, state, make_train_step(model, state,
                                         resize_cross_entropy_loss,
                                         device="cpu"), x, y


def test_cost_analysis_counts_a_matmul():
    a = torch.zeros(128, 128)
    ca = profiling.cost_analysis(lambda x, y: x @ y, a, a)
    assert ca["flops"] >= 2 * 128 ** 3 * 0.9
    assert ca["bytes_accessed"] == 3 * 128 * 128 * 4
    assert ca["transcendentals"] == 0 and ca["kernel_launches"] == {}


def test_cost_analysis_of_a_train_step():
    _, _, step, x, y = _step()
    ca = profiling.cost_analysis(step, x, y)
    assert ca["flops"] > 1e8 and ca["bytes_accessed"] > 1e7
    assert ca["transcendentals"] >= 2 * 64 * 128 * 19  # exp and log a pixel
    assert ca["kernel_launches"] == {}
    assert set(profiling.launch_counts()) == {
        "sepconv", "resize_ce_fwd", "resize_ce_bwd", "mbconv_fwd",
        "mbconv_bwd", "depthwise_fwd", "depthwise_bwd", "upsample_concat",
        "resize_ce_map_fwd", "resize_ce_map_bwd"}


def test_measure_trace_and_memory_stats(tmp_path):
    sps, out = profiling.measure(lambda x: x * 1.0001, torch.ones(8, 8),
                                 steps=3)
    assert sps > 0 and np.isfinite(sps) and out.shape == (8, 8)
    assert profiling.sync({"loss": torch.tensor(2.5)}) == 2.5
    with profiling.trace(str(tmp_path)) as path:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names
    assert profiling.memory_stats() is None


@pytest.fixture
def nan_debugging():
    debug.enable_nan_debugging()
    try:
        yield
    finally:
        debug.enable_nan_debugging(False)


def test_nan_debugging_names_the_op(nan_debugging):
    with pytest.raises(FloatingPointError, match="aten::log"):
        torch.log(torch.zeros(3))
    x = torch.zeros(3, requires_grad=True)
    with pytest.warns(UserWarning, match="SqrtBackward0"), \
            pytest.raises(FloatingPointError, match="aten::div"):
        # the forward is finite; the backward's g/(2·sqrt(0)) is not, and
        # anomaly mode names the backward function it ran in
        torch.sqrt(x).sum().backward()


def test_kernel_outputs_are_checked_while_debugging(monkeypatch):
    """What a kernel writes through ctypes no dispatch mode sees: its
    wrapper checks it under `enable_nan_debugging` (`CHECK_FINITE`)."""
    bad = torch.tensor([1.0, np.nan])
    kernels.check_finite("mbconv forward", bad)
    monkeypatch.setattr(kernels, "CHECK_FINITE", True)
    kernels.check_finite("mbconv forward", torch.ones(2))
    with pytest.raises(FloatingPointError, match="the mbconv forward kernel"):
        kernels.check_finite("mbconv forward", bad)


def test_nan_debugging_off_again():
    debug.enable_nan_debugging()
    debug.enable_nan_debugging(False)
    assert torch.isneginf(torch.log(torch.zeros(1))).all()
    assert not kernels.CHECK_FINITE


@pytest.mark.parametrize("x", [1.0, 0.0])
def test_checked_step_raises_where_jax_raises(x):
    """The JAX package's test's step, log(x): finite at 1, -inf at 0."""
    jstep = jdebug.checked_step(lambda s, v: (s, {"loss": jnp.log(v)}))
    tstep = debug.checked_step(lambda s, v: (s, {"loss": torch.log(v)}))
    try:
        jstep(jnp.zeros(()), jnp.asarray(x))
        jraised = False
    except Exception as e:
        assert "non-finite" in str(e)
        jraised = True
    if jraised:
        with pytest.raises(FloatingPointError, match="non-finite loss"):
            tstep(torch.zeros(()), torch.tensor(x))
    else:
        _, m = tstep(torch.zeros(()), torch.tensor(x))
        assert float(m["loss"]) == 0.0
    assert jraised == (x == 0.0)


def test_checked_train_step_keeps_the_state():
    model, state, step, x, y = _step()
    checked = debug.checked_step(step)
    checked(x, y)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    momenta = [state.optimizer.state[p]["momentum_buffer"].clone()
               for p in model.parameters()]
    sched = state.scheduler.state_dict()
    bad = x.clone()
    bad[1, 7, 9, 2] = float("nan")
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        checked(bad, y)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    for p, m in zip(model.parameters(), momenta, strict=True):
        assert torch.equal(state.optimizer.state[p]["momentum_buffer"], m)
    assert state.scheduler.state_dict() == sched
    # the same step, unchecked, does move the running statistics
    step(bad, y)
    assert not torch.equal(model.state_dict()["lds.conv.bn.running_mean"],
                           sd["lds.conv.bn.running_mean"])


def test_checked_train_step_raises_on_a_gradient_the_loss_hides():
    """A loss that maps NaN logits to −80, as K1's clip does on the card,
    stays finite over a NaN pixel; the gradients do not, and the checked
    step raises naming one, keeping the state."""
    model = fastscnn(19, upsample_logits=False, device="cpu")
    state = create_train_state(model, OptimizerConfig(lr=0.01, max_steps=4))

    def clipped(logits, labels):
        return resize_cross_entropy_loss(
            torch.where(logits.isnan(), -80.0, logits), labels)

    step = debug.checked_step(make_train_step(model, state, clipped,
                                              device="cpu"))
    _, _, _, x, y = _step()
    x[0, 3, 3, 1] = float("nan")
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(FloatingPointError,
                       match="non-finite gradient of .* at a finite loss"):
        step(x, y)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_checked_step_that_passes_equals_the_unchecked_step():
    """A finite step through `checked_step` applies the held-back running
    statistics: it equals the unchecked step bit for bit."""
    runs = []
    for check in (False, True):
        model, state, step, x, y = _step()
        (debug.checked_step(step) if check else step)(x, y)
        runs.append(model.state_dict())
    for k, v in runs[0].items():
        assert torch.equal(runs[1][k], v), k
