"""PyTorch port, the fused ×2 bilinear upsample + skip concat (K4) on the
CPU, where its wrapper runs the plain version: against the JAX package's
Pallas kernel in interpret mode (`pallas_upsample._fused(low, skip, True)`)
at the shapes of `test_pallas.py`, H = W = 1, and one UpBlock-like shape.

Tolerances: both sides compute each product and sum in float32 in the same
order and round once to the output type, so float32 agrees to 1e-5 (XLA's
CPU code may contract a product into a fused multiply-add) and bf16 to one
bf16 step of each element (2^-7 relative, where such a difference crosses
a rounding boundary). The gradient, the channel slice and the adjoint
resize as float32 products on both sides, at 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_semantic_segmentation_tpu.ops.pallas_upsample import _fused
from torch_semantic_segmentation_tpu_torch.ops import upsample_concat as uc

torch.set_num_threads(2)

# (h, w, cl, cs): test_pallas.py's shapes, H = W = 1, and an UpBlock-like
# shape (Cl = Cs = 32, the decoder's channel plan at base 32)
SHAPES = [(8, 16, 4, 4), (6, 10, 3, 5), (16, 8, 128, 64), (4, 4, 1, 2),
          (1, 1, 3, 5), (12, 16, 32, 32)]


def _data(h, w, cl, cs, seed=0, n=2):
    rng = np.random.default_rng(seed)
    low = rng.normal(size=(n, h, w, cl)).astype(np.float32)
    skip = rng.normal(size=(n, 2 * h, 2 * w, cs)).astype(np.float32)
    return low, skip


@pytest.mark.parametrize("h,w,cl,cs", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax_kernel(h, w, cl, cs, dtype):
    low, skip = _data(h, w, cl, cs)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(_fused(jnp.asarray(low, jdt), jnp.asarray(skip, jdt),
                             True).astype(jnp.float32))
    before = uc.upsample_concat_forward.launches
    got = uc.upsample2x_concat(torch.from_numpy(low).to(tdt),
                               torch.from_numpy(skip).to(tdt))
    assert uc.upsample_concat_forward.launches == before   # the CPU: no kernel
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    if dtype == "float32":
        tol = dict(rtol=1e-5, atol=1e-5)
    else:
        tol = dict(rtol=2.0 ** -7, atol=0)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    # the skip channels are copied as they are
    np.testing.assert_array_equal(got[..., cl:].float().numpy(),
                                  torch.from_numpy(skip).to(tdt).float().numpy())


@pytest.mark.parametrize("h,w,cl,cs", [SHAPES[1], SHAPES[5]])
def test_gradient_matches_jax(h, w, cl, cs):
    low, skip = _data(h, w, cl, cs, seed=1)
    jl, js = jax.grad(lambda a, b: jnp.sum(jnp.sin(_fused(a, b, True))),
                      (0, 1))(jnp.asarray(low), jnp.asarray(skip))
    tl = torch.from_numpy(low).requires_grad_(True)
    ts = torch.from_numpy(skip).requires_grad_(True)
    torch.sin(uc.upsample2x_concat(tl, ts)).sum().backward()
    for got, want in ((tl.grad, jl), (ts.grad, js)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_bf16_gradient_dtypes_and_shape_checks():
    low, skip = _data(4, 6, 8, 8)
    tl = torch.from_numpy(low).to(torch.bfloat16).requires_grad_(True)
    ts = torch.from_numpy(skip).to(torch.bfloat16).requires_grad_(True)
    uc.upsample2x_concat(tl, ts).float().sum().backward()
    assert tl.grad.dtype == torch.bfloat16 and ts.grad.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="2H, 2W"):
        uc.upsample_concat_forward(torch.zeros(1, 4, 4, 2),
                                   torch.zeros(1, 8, 6, 2))


def test_reference_is_the_matrix_resize():
    """The 2-tap lerp is the align_corners=False bilinear resize: against
    `torch.nn.functional.interpolate` at float64 accuracy."""
    low, _ = _data(5, 7, 3, 1)
    x = torch.from_numpy(low).double()
    got = uc.upsample2x_reference(x)
    want = torch.nn.functional.interpolate(
        x.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want.float().numpy(), rtol=1e-6,
                               atol=1e-6)
