"""PyTorch port, K5: `ops.sepconv.fused_separable_conv` against the JAX
package's `fused_separable_conv(..., use_pallas=True)`, which on the CPU
runs the Pallas kernel in interpret mode. Here the port's wrapper gets CPU
tensors and runs its plain version; the CUDA kernel itself is held against
that plain version by tests/test_torch_cuda.py and chip_smoke.py.
Tolerance 1e-5: float32 on both sides."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from torch_semantic_segmentation_tpu.ops import SeparableConv as JSeparableConv
from torch_semantic_segmentation_tpu.ops.pallas_sepconv import (
    fused_separable_conv as j_fused)
from torch_semantic_segmentation_tpu_torch import kernels
from torch_semantic_segmentation_tpu_torch.ops import SeparableConv
from torch_semantic_segmentation_tpu_torch.ops import sepconv
from torch_semantic_segmentation_tpu_torch.ops.fold import fold_batchnorm

from tests.test_torch_resize_ce_map_bwd import check_variant
from tests.torch_port_util import carry_weights

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
ROOT = Path(__file__).resolve().parent.parent
SEPCONV_CU = ROOT / "torch_semantic_segmentation_tpu_torch" / "csrc" / "sepconv.cu"
SEPCONV_PROBE = ROOT / "scripts" / "torch_sepconv_probe.py"


def _inputs(seed, h, w, c, co, n=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, h, w, c)).astype(np.float32),
            (rng.normal(size=(3, 3, c)) * 0.2).astype(np.float32),
            (rng.normal(size=(c,)) * 0.1).astype(np.float32),
            (rng.normal(size=(c, co)) * 0.2).astype(np.float32),
            (rng.normal(size=(co,)) * 0.1).astype(np.float32))


def _both(arrays, **kw):
    want = np.asarray(j_fused(*map(jnp.asarray, arrays), use_pallas=True, **kw))
    got = sepconv.fused_separable_conv(*map(torch.from_numpy, arrays), **kw)
    return got.numpy(), want


@pytest.mark.parametrize("h,w,c,co,dil", [
    (16, 24, 8, 16, 1),       # plain
    (16, 24, 8, 16, 4),       # FFM-style dilated dw
    (12, 40, 24, 8, 1),       # non-pow2 W, C>Co
    (8, 8, 3, 5, 2),          # tiny channels, border-heavy
])
def test_matches_jax_kernel(h, w, c, co, dil):
    got, want = _both(_inputs(0, h, w, c, co), dilation=dil)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("relu_mid,relu_out",
                         [(False, True), (True, False), (False, False)])
def test_relu_variants(relu_mid, relu_out):
    got, want = _both(_inputs(1, 8, 16, 4, 4), relu_mid=relu_mid,
                      relu_out=relu_out)
    np.testing.assert_allclose(got, want, **TOL)


def test_stride2_plain_version():
    got, want = _both(_inputs(3, 8, 8, 4, 6), stride=2)
    assert got.shape == (2, 4, 4, 6)
    np.testing.assert_allclose(got, want, **TOL)


def test_bf16_rounds_mid_like_jax():
    x, dwk, dwb, pwk, pwb = _inputs(5, 8, 16, 8, 8)
    want = np.asarray(j_fused(jnp.asarray(x, jnp.bfloat16), jnp.asarray(dwk),
                              jnp.asarray(dwb),
                              jnp.asarray(pwk, jnp.bfloat16), jnp.asarray(pwb),
                              use_pallas=True).astype(jnp.float32))
    got = sepconv.fused_separable_conv(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(dwk),
        torch.from_numpy(dwb), torch.from_numpy(pwk).bfloat16(),
        torch.from_numpy(pwb))
    assert got.dtype == torch.bfloat16
    # one bf16 step of the output's scale: the two sides may round a sum
    # that lies on a bf16 boundary apart
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0 ** -7 * np.abs(want).max())


def test_fuse_conv_pair_routing():
    """A folded stride-1 pair fuses; an unfolded or strided one does not."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 8, 12, 6)).astype(np.float32))
    sep = SeparableConv(6, 10, 3).eval()
    assert sepconv.fuse_conv_pair(sep.dw, sep.pw, x) is None
    fold_batchnorm(sep)
    assert sepconv.fuse_conv_pair(sep.dw, sep.pw, x) is not None
    strided = SeparableConv(6, 10, 3, stride=2).eval()
    fold_batchnorm(strided)
    assert sepconv.fuse_conv_pair(strided.dw, strided.pw, x) is None


def test_folded_module_matches_jax_module():
    """JAX SeparableConv with random BN stats, folded (unfused on the CPU)
    vs the port's folded module, which runs the fused path."""
    from torch_semantic_segmentation_tpu.ops.fold import (
        fold_batchnorm as j_fold)

    j = JSeparableConv(6, 10, 3, rngs=nnx.Rngs(0))
    t = carry_weights(j, SeparableConv(6, 10, 3), seed=4)
    j_fold(j)
    fold_batchnorm(t)
    x = np.random.default_rng(5).normal(size=(2, 8, 12, 6)).astype(np.float32)
    want = np.asarray(j(jnp.asarray(x)))
    with torch.no_grad():
        got = t(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_rejects_other_devices():
    args = [torch.empty(s, device="meta")
            for s in ((1, 4, 4, 2), (3, 3, 2), (2,), (2, 3), (3,))]
    with pytest.raises(ValueError, match="no kernel"):
        sepconv.fused_separable_conv(*args)


def test_library_path_keyed_on_source():
    p = kernels.library_path("sepconv")
    assert p.parent == kernels.BUILD_DIR
    assert p == kernels.library_path("sepconv")
    assert p.name.startswith("libsepconv-")


def test_folded_pair_keeps_its_kernel_weights():
    """A folded pair makes its weights in the kernel's layouts once and
    keeps them while its parameters are unchanged: the output equals the
    fused conv with the weights laid out afresh, on every call, and after an
    in-place update or `load_state_dict` it follows the new weights. Where
    autograd records, the gradient reaches the parameters."""
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 8, 12, 6)).astype(np.float32))
    sep = SeparableConv(6, 10, 3).eval()
    fold_batchnorm(sep)
    dwc, pwc = sep.dw.conv, sep.pw.conv

    def fresh():
        return sepconv.fused_separable_conv(
            x, dwc.weight.reshape(6, 3, 3).permute(1, 2, 0), dwc.bias,
            pwc.weight.reshape(10, 6).t(), pwc.bias)

    with torch.no_grad():
        got = sep(x)
        kept = sep.pw._sepconv_weights[2]
        assert torch.equal(got, fresh())
        assert torch.equal(sep(x), got)
        assert sep.pw._sepconv_weights[2] is kept
        pwc.weight.mul_(0.5)
        assert torch.equal(sep(x), fresh())
        assert sep.pw._sepconv_weights[2] is not kept
        sep.load_state_dict({k: v * 2 for k, v in sep.state_dict().items()})
        assert torch.equal(sep(x), fresh())
    with torch.inference_mode():
        served = sep(x)
    with torch.no_grad():
        assert torch.equal(served, fresh())
        assert torch.equal(sep(x), served)
    sep(x).sum().backward()
    assert dwc.weight.grad is not None and pwc.weight.grad is not None
    assert float(pwc.weight.grad.abs().sum()) > 0


@pytest.mark.parametrize("variant", ["k5_no_product", "k5_no_taps",
                                     "k5_no_stage", "k5_no_store"])
def test_probe_variant_patches_only_its_kernel(variant):
    """Each variant of `scripts/torch_sepconv_probe.py` names one kernel
    that `sepconv.cu` defines and changes lines inside its body only."""
    check_variant(SEPCONV_CU, SEPCONV_PROBE, variant)
