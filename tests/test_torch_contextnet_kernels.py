"""PyTorch port, the plain versions of K2 and K6 on the CPU against the JAX
package's Pallas kernels in interpret mode, at ContextNet's new shapes:

- K2's plain version (`mbconv.fused_expand_dw` on CPU tensors:
  `expand_dw_reference` and its backward) at Cin 32 / Ce 32, stride 1, and
  Cin 48 / Ce 288, stride 2, on small maps, at the bars of
  tests/test_torch_mbconv.py. The TPU kernel takes Ce in 128-lane blocks
  (its `supports` needs Ce % 128 == 0; in interpret mode it raises at
  Ce 288, stride 2), so it runs at Ce rounded up to a multiple of 128 with
  the extra channels' weights, bias and taps 0: their expanded values are
  relu(0) = 0 and add exact zeros to dx; the output and dW′, db′, dk are
  sliced back to Ce;
- K6's plain version (`depthwise.depthwise_conv3x3` on CPU tensors) at
  C = 64 (the detail branch's `ds2`), stride 2, bf16, at the bars of
  tests/test_torch_depthwise.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_semantic_segmentation_tpu.ops import pallas_dw, pallas_mbconv

from tests import test_torch_depthwise as dw_util
from tests import test_torch_mbconv as mb_util

torch.set_num_threads(2)


# ContextNet's new K2 block shapes, small maps: (x shape, Ce, stride)
K2_CASES = [((2, 8, 16, 32), 32, 1), ((2, 8, 16, 48), 288, 2)]


@pytest.mark.parametrize("shape,ce,stride", K2_CASES)
def test_k2_plain_version_matches_jax_kernel(shape, ce, stride):
    x, wt, b, k = mb_util._make(shape, ce)
    n, h, w, cin = shape
    ct = mb_util._cotangent((n, h // stride, w // stride, ce))
    pad = -ce % 128
    want_y, want_g = mb_util._jax_fwd_grads(
        lambda *a: pallas_mbconv.fused_expand_dw(*a, stride, True),
        x, np.pad(wt, ((0, 0), (0, pad))), np.pad(b, (0, pad)),
        np.pad(k, ((0, 0), (0, 0), (0, pad))),
        np.pad(ct, ((0, 0), (0, 0), (0, 0), (0, pad))))
    want_y = want_y[..., :ce]
    want_g = [want_g[0], want_g[1][:, :ce], want_g[2][:ce],
              want_g[3][..., :ce]]
    got_y, got_g = mb_util._port_fwd_grads(x, wt, b, k, stride, ct)
    assert got_y.shape == want_y.shape
    assert mb_util._rel(got_y, want_y) <= 2.0 ** -8
    for name, g, r in zip(["dx", "dw", "db", "dk"], got_g, want_g):
        assert g.shape == r.shape, name
        assert mb_util._rel(g, r) <= 2.0 ** -7, (name, mb_util._rel(g, r))


def test_k6_plain_version_matches_jax_kernel_at_c64():
    shape, stride = (2, 16, 32, 64), 2
    x, k = dw_util._make(shape, seed=7)
    oshape = dw_util._out_shape(shape, stride)
    ct = np.cos(np.arange(np.prod(oshape), dtype=np.float32)).reshape(oshape)
    want = dw_util._jax_fwd_grads(
        lambda a, kk: pallas_dw.depthwise_conv3x3(a, kk, stride=stride,
                                                  interpret=True),
        x, k, ct, jnp.bfloat16)
    got = dw_util._port_fwd_grads(x, k, stride, ct, torch.bfloat16)
    for name, g, r in zip(("y", "dx", "dk"), got, want):
        assert g.shape == r.shape, name
    assert dw_util._rel(got[0], want[0]) <= 2.0 ** -8
    assert dw_util._rel(got[1], want[1]) <= 2.0 ** -8
    assert dw_util._rel_l2(got[2], want[2]) <= 1e-5
