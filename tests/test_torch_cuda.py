"""PyTorch port, kernels on the card: each Hopper kernel against its plain
PyTorch version. These tests need a CUDA card and skip without one. This
file imports neither JAX nor the JAX package, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from torch_semantic_segmentation_tpu_torch.ops import sepconv

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _sepconv_inputs(seed, h, w, c, co, device, n=2):
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(n, h, w, c)), rng.normal(size=(3, 3, c)) * 0.2,
              rng.normal(size=(c,)) * 0.1, rng.normal(size=(c, co)) * 0.2,
              rng.normal(size=(co,)) * 0.1)
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c,co,dil,relu_mid,relu_out", [
    (16, 24, 8, 16, 1, True, True),
    (16, 24, 8, 16, 4, True, False),
    (12, 40, 24, 8, 1, False, True),
    (8, 8, 3, 5, 2, False, False),
    (9, 33, 160, 72, 4, True, True),   # C over one channel chunk, Co ragged
    (9, 33, 64, 136, 4, True, False),  # 16-byte loads, Co over one pass
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sepconv_kernel_matches_plain_version(cuda, h, w, c, co, dil,
                                              relu_mid, relu_out, dtype):
    dtype = getattr(torch, dtype)
    x, dwk, dwb, pwk, pwb = _sepconv_inputs(6, h, w, c, co, cuda)
    args = (x.to(dtype), dwk, dwb, pwk.to(dtype), pwb)
    kw = dict(dilation=dil, relu_mid=relu_mid, relu_out=relu_out)
    before = sepconv.fused_separable_conv.launches
    got = sepconv.fused_separable_conv(*args, **kw).float()
    assert sepconv.fused_separable_conv.launches == before + 1
    want = sepconv.separable_conv_reference(*args, **kw).float()
    torch.cuda.synchronize()
    if dtype == torch.float32:
        tol = dict(rtol=1e-4, atol=1e-4)
    else:
        # the mma sums in another order; a sum on a bf16 boundary may round
        # one step apart: two bf16 steps at the top of the output's range
        tol = dict(rtol=0, atol=2.0 ** -6 * float(want.abs().max()))
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **tol)


@pytest.mark.cuda
def test_sepconv_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, dwk, dwb, pwk, pwb = _sepconv_inputs(7, 8, 8, 4, 4, cuda)
    with pytest.raises(ValueError, match="stride"):
        sepconv.fused_separable_conv(x, dwk, dwb, pwk, pwb, stride=2)
    with pytest.raises(ValueError, match="contiguous"):
        sepconv.fused_separable_conv(x.permute(0, 2, 1, 3), dwk, dwb, pwk, pwb)
    with pytest.raises(TypeError):
        sepconv.fused_separable_conv(x.half(), dwk, dwb, pwk.half(), pwb)
    with pytest.raises(TypeError, match="pw kernel"):
        sepconv.fused_separable_conv(x.bfloat16(), dwk, dwb, pwk, pwb)
    with pytest.raises(ValueError, match="must be on"):
        sepconv.fused_separable_conv(x, dwk.cpu(), dwb, pwk, pwb)
