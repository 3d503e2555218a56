"""PyTorch port, LEDNet on the CPU against the JAX package, in float32, the
JAX weights carried by `export_torch_state_dict` → `state_dict_from_jax`
and loaded with strict=True, the JAX package on its plain path
(`TPU_SEG_PACKED_LEDNET{,_BODY}=0`; it takes its packed body only on a
TPU):

- `channel_shuffle` equal to JAX's, bit for bit;
- the split-shuffle block (`SSnbt`, dilation 1 and 5) and the APN head in
  train mode at 1e-5 of scale;
- LEDNet at 4x64x64 on both `upsample_logits` routes: eval logits at 1e-4
  of scale; one SGD step, plain CE on the full-resolution logits or the
  resize CE on the 1/8 ones, dropout at rate 0 on both sides (the
  frameworks draw different masks), against the JAX package's step in
  float64 (`jax_enable_x64`, the float32 draw cast): the loss at rtol
  1e-4, every parameter and BN statistic at the measured rtol = atol =
  5e-4, and the parameters' movement within relative L2 0.1 of JAX's (a
  step that drops the gradient reads 1); one `remat=True` step bit for
  bit against the step without it; the "divisible by 16" ValueError
  raised by both packages.

A batch of 4: in train mode the APN's `pool_proj` BN normalises over the
N values of a (N,1,1,C) tensor, as ASPP's image-level BN does in
tests/test_torch_deeplab.py. The tolerance, measured by
`python scripts/port_sgd_gap.py lednet --batch 4 [--low-res]`: after one
step the port's worst parameter (`encoder.1.left.0.weight`) lies 2.51
times the 1e-4 bar from JAX's float64 step, on both routes, and JAX's own
float32 step 11.1 times; the losses 3.3e-7 and 2.2e-7 apart (JAX float32
1.2e-5); the parameters' movement 0.0077 off JAX float64's (JAX float32
0.040). So the state's bar is 5e-4. One step, not three: the APN
multiply `main(x) · a` and the train-mode BNs make the later steps
chaotic, in the JAX package too; after 3 steps the port lies 561 and 556
bars from JAX's float64 run and JAX's float32 run 891 and 939, the
parameters' movement 0.69 and 0.68 off (JAX float32 0.90 and 0.94), so no
bar there could tell a wrong gradient from rounding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from torch_semantic_segmentation_tpu import losses as jlosses
from torch_semantic_segmentation_tpu.models.lednet import (
    APN as JAPN, SSnbt as JSSnbt, channel_shuffle as j_channel_shuffle,
    lednet as j_lednet)
from torch_semantic_segmentation_tpu_torch import losses as tlosses
from torch_semantic_segmentation_tpu_torch.models import get_model
from torch_semantic_segmentation_tpu_torch.models.lednet import (
    APN, SSnbt, channel_shuffle)
from torch_semantic_segmentation_tpu_torch.ops.dropout import Dropout

from torch_port_util import (
    carry_weights, jax_model_at, jax_x64, movement_gaps,
    remat_step_is_bit_exact, sgd_steps_match_jax)

torch.set_num_threads(2)

N, H, W, C = 4, 64, 64, 5
# one step against JAX's float64 step: every parameter and BN statistic
# at rtol = atol = STATE_TOL, the parameters' movement at relative L2
# MOVE_TOL (measured 2.51e-4 and 0.0077)
STATE_TOL, MOVE_TOL = 5e-4, 0.1


@pytest.fixture(autouse=True)
def _plain_jax_path(monkeypatch):
    monkeypatch.setenv("TPU_SEG_PACKED_LEDNET", "0")
    monkeypatch.setenv("TPU_SEG_PACKED_LEDNET_BODY", "0")


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("groups", [2, 4])
def test_channel_shuffle_matches_jax(groups):
    x = np.arange(2 * 3 * 5 * 16, dtype=np.float32).reshape(2, 3, 5, 16)
    got = channel_shuffle(torch.from_numpy(x), groups).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(j_channel_shuffle(jnp.asarray(x), groups)))
    # channel g·(C/groups) + i lands at i·groups + g
    assert got[0, 0, 0, 1] == x[0, 0, 0, 16 // groups]


BLOCKS = {
    "ssnbt_d1": (lambda r: JSSnbt(16, dropout=0.0, rngs=r),
                 lambda: SSnbt(16, dropout=0.0), 16),
    "ssnbt_d5": (lambda r: JSSnbt(16, dilation=5, dropout=0.0, rngs=r),
                 lambda: SSnbt(16, dilation=5, dropout=0.0), 16),
    "apn": (lambda r: JAPN(12, C, rngs=r), lambda: APN(12, C), 12),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax_in_train_mode(name):
    make_j, make_t, cin = BLOCKS[name]
    j, t = make_j(nnx.Rngs(0)), make_t()
    carry_weights(j, t, seed=1)
    j.train()
    t.train()
    x = np.random.default_rng(2).normal(size=(N, 16, 24, cin)).astype(
        np.float32)
    with torch.no_grad():
        got = t(torch.from_numpy(x)).numpy()
    want = np.asarray(j(jnp.asarray(x)))
    assert got.shape == want.shape
    _close(got, want, 1e-5)


def _models(upsample_logits=True, rate=None):
    j = j_lednet(C, upsample_logits=upsample_logits, rngs=nnx.Rngs(0))
    t = get_model("lednet", C, upsample_logits=upsample_logits, device="cpu")
    if rate is not None:
        for _, m in nnx.iter_graph(j):
            if isinstance(m, nnx.Dropout):
                m.rate = rate
        for m in t.modules():
            if isinstance(m, Dropout):
                m.rate = rate
    return j, t


def _batches(steps, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        x = rng.normal(size=(N, H, W, 3)).astype(np.float32)
        y = rng.integers(0, C, (N, H, W)).astype(np.int32)
        y[:, :4, :9] = 255
        out.append((x, y))
    return out


@pytest.mark.parametrize("upsample_logits", [True, False])
def test_eval_logits_match_jax(upsample_logits):
    j, t = _models(upsample_logits)
    carry_weights(j, t, seed=4)
    x = _batches(1)[0][0]
    with torch.no_grad():
        got = t(torch.from_numpy(x)).numpy()
    s = 1 if upsample_logits else 8
    assert got.shape == (N, H // s, W // s, C)
    _close(got, np.asarray(j(jnp.asarray(x))), 1e-4)


@pytest.mark.parametrize("upsample_logits", [True, False])
def test_sgd_steps_match_jax(upsample_logits):
    j, t = _models(upsample_logits, rate=0.0)
    if upsample_logits:
        jloss, tloss = jlosses.cross_entropy_loss, tlosses.cross_entropy_loss
    else:
        jloss, tloss = (jlosses.resize_cross_entropy_loss,
                        tlosses.resize_cross_entropy_loss)
    with jax_x64():
        run = sgd_steps_match_jax(jax_model_at(j, jnp.float64), t, jloss,
                                  tloss, _batches(1), state_tol=STATE_TOL)
    assert movement_gaps(run)["parameters"] <= MOVE_TOL


def test_remat_step_equals_the_step_without_remat():
    x, y = (torch.from_numpy(a) for a in _batches(1, seed=5)[0])
    rates = {m.rate for m in get_model("lednet", C, device="cpu").modules()
             if isinstance(m, Dropout)}
    assert rates == {0.03, 0.3}
    remat_step_is_bit_exact(
        lambda: get_model("lednet", C, upsample_logits=False, device="cpu"),
        tlosses.resize_cross_entropy_loss, x, y)


def test_both_packages_refuse_sizes_off_16():
    j, t = _models()
    x = np.zeros((1, 64, 40, 3), np.float32)
    with pytest.raises(ValueError, match="divisible by 16"):
        j(jnp.asarray(x))
    with pytest.raises(ValueError, match="divisible by 16"):
        t(torch.from_numpy(x))
