"""PyTorch port, ERFNet and ESNet on the CPU against the JAX package, in
float32, the JAX weights carried by `export_torch_state_dict` →
`state_dict_from_jax` and loaded with strict=True, the JAX package on its
plain path (`TPU_SEG_PACKED_{ERFNET,ESNET}{,_BODY}=0`; it takes its packed
body and head only on a TPU):

- each block (ERFNet's downsampler, non-bottleneck-1d and upsampler,
  ESNet's FCU at K = 3 and 5 and PFCU) in train mode at 1e-5 of scale;
- both models at 2x64x64: eval logits at 1e-4 of scale; one SGD step with
  plain cross-entropy (ignore_index 255), dropout at rate 0 on both sides
  (the frameworks draw different masks), against the JAX package's step
  in float64 (`jax_enable_x64`, the float32 draw cast): the loss at rtol
  1e-4, every parameter and BN statistic at rtol = atol = 1e-4, and the
  parameters' movement within relative L2 0.1 of JAX's (a step that drops
  the gradient reads 1); one `remat=True` step bit for bit against the
  step without it, with the models' own dropout rates; the "divisible by
  8" ValueError raised by both packages.

One step, not three: from the second step on these models' steps are
chaotic (each residual block's train-mode BN stacks multiply a
perturbation, and the gradients follow the ReLU masks), in the JAX
package too. `python scripts/port_sgd_gap.py erfnet|esnet` reads, after
1 / 3 steps, the worst parameter or BN statistic over the 1e-4 bar: the
port's float32 steps against JAX's float64 ones 0.388 / 53.8 (ERFNet) and
0.370 / 22.4 (ESNet), JAX's own float32 steps 1.46 / 96.8 and 0.866 /
31.4; the parameters' movement off JAX float64's, relative L2: the port
0.018 / 0.51 and 0.022 / 0.41, JAX float32 0.055 / 0.69 and 0.037 / 0.46.
So after three steps no bar could tell a wrong gradient from rounding;
after one, the port holds 1e-4 where JAX's float32 step does not
(ERFNet)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from torch_semantic_segmentation_tpu.losses import (
    cross_entropy_loss as j_ce_loss)
from torch_semantic_segmentation_tpu.models.erfnet import (
    DownsamplerBlock as JDown, NonBottleneck1d as JNb1d,
    UpsamplerBlock as JUp, erfnet as j_erfnet)
from torch_semantic_segmentation_tpu.models.esnet import (
    FCU as JFCU, PFCU as JPFCU, esnet as j_esnet)
from torch_semantic_segmentation_tpu_torch.losses import cross_entropy_loss
from torch_semantic_segmentation_tpu_torch.models import get_model
from torch_semantic_segmentation_tpu_torch.models.erfnet import (
    DownsamplerBlock, NonBottleneck1d, UpsamplerBlock)
from torch_semantic_segmentation_tpu_torch.models.esnet import FCU, PFCU
from torch_semantic_segmentation_tpu_torch.ops.dropout import Dropout

from torch_port_util import (
    carry_weights, jax_model_at, jax_x64, movement_gaps,
    remat_step_is_bit_exact, sgd_steps_match_jax)

torch.set_num_threads(2)

N, H, W, C = 2, 64, 64, 5
MODELS = {"erfnet": j_erfnet, "esnet": j_esnet}
# relative L2 of the parameters' movement after one step against JAX's
# float64 step (measured 0.018 and 0.022, JAX's float32 step 0.055, 0.037)
MOVE_TOL = 0.1


@pytest.fixture(autouse=True)
def _plain_jax_path(monkeypatch):
    for name in ("ERFNET", "ESNET"):
        monkeypatch.setenv(f"TPU_SEG_PACKED_{name}", "0")
        monkeypatch.setenv(f"TPU_SEG_PACKED_{name}_BODY", "0")


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


# (JAX block, port block, input channels); dropout at rate 0, so that
# train mode compares the BNs' batch statistics
BLOCKS = {
    "downsampler": (lambda r: JDown(6, 16, rngs=r),
                    lambda: DownsamplerBlock(6, 16), 6),
    "non_bottleneck_1d": (
        lambda r: JNb1d(8, dilation=2, dropout=0.0, rngs=r),
        lambda: NonBottleneck1d(8, dilation=2, dropout=0.0), 8),
    "upsampler": (lambda r: JUp(8, 6, rngs=r), lambda: UpsamplerBlock(8, 6),
                  8),
    "fcu_k3": (lambda r: JFCU(8, 3, dropout=0.0, rngs=r),
               lambda: FCU(8, 3, dropout=0.0), 8),
    "fcu_k5": (lambda r: JFCU(8, 5, dropout=0.0, rngs=r),
               lambda: FCU(8, 5, dropout=0.0), 8),
    "pfcu": (lambda r: JPFCU(8, dropout=0.0, rngs=r),
             lambda: PFCU(8, dropout=0.0), 8),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax_in_train_mode(name):
    make_j, make_t, cin = BLOCKS[name]
    j, t = make_j(nnx.Rngs(0)), make_t()
    carry_weights(j, t, seed=1)
    j.train()
    t.train()
    x = np.random.default_rng(2).normal(size=(2, 12, 20, cin)).astype(
        np.float32)
    with torch.no_grad():
        got = t(torch.from_numpy(x)).numpy()
    want = np.asarray(j(jnp.asarray(x)))
    assert got.shape == want.shape
    _close(got, want, 1e-5)


def _models(name, rate=None):
    j = MODELS[name](C, rngs=nnx.Rngs(0))
    t = get_model(name, C, device="cpu")
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


@pytest.mark.parametrize("name", sorted(MODELS))
def test_eval_logits_match_jax(name):
    j, t = _models(name)
    carry_weights(j, t, seed=4)
    x = _batches(1)[0][0]
    with torch.no_grad():
        got = t(torch.from_numpy(x)).numpy()
    assert got.shape == (N, H, W, C)
    _close(got, np.asarray(j(jnp.asarray(x))), 1e-4)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_sgd_steps_match_jax(name):
    j, t = _models(name, rate=0.0)
    with jax_x64():
        run = sgd_steps_match_jax(jax_model_at(j, jnp.float64), t, j_ce_loss,
                                  cross_entropy_loss, _batches(1))
    assert movement_gaps(run)["parameters"] <= MOVE_TOL


@pytest.mark.parametrize("name", sorted(MODELS))
def test_remat_step_equals_the_step_without_remat(name):
    x, y = (torch.from_numpy(a) for a in _batches(1, seed=5)[0])
    rates = {m.rate for m in get_model(name, C, device="cpu").modules()
             if isinstance(m, Dropout)}
    assert rates == {0.0, 0.03, 0.3}
    remat_step_is_bit_exact(lambda: get_model(name, C, device="cpu"),
                            cross_entropy_loss, x, y)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_both_packages_refuse_sizes_off_8(name):
    j, t = _models(name)
    x = np.zeros((1, 36, 64, 3), np.float32)
    with pytest.raises(ValueError, match="divisible by 8"):
        j(jnp.asarray(x))
    with pytest.raises(ValueError, match="divisible by 8"):
        t(torch.from_numpy(x))
