"""Depthwise 3×3 convolution, zero padding 1, no bias, stride 1 or 2, with
its Hopper kernels, forward and backward.

    y[n,i,j,c] = Σ_{dh,dw} x[n, s·i+dh−1, s·j+dw−1, c] · k[dh,dw,c]

`depthwise_conv3x3` is an autograd function. Its forward calls
`depthwise3x3_forward` and its backward `depthwise3x3_backward`; each
launches its CUDA kernels (`csrc/depthwise.cu`) for tensors on the card and
runs the plain PyTorch version for tensors on the CPU. They replace the JAX
package's Pallas kernels of `ops/pallas_dw.py` (`_make_s1_fwd`,
`_make_s2_fwd`, `_make_s2_bwd_dx`, `_make_s1_bwd_dk`, `_make_s2_bwd_dk`).

Rounding points, those of the JAX package's routed path:
- bf16 x is widened exactly to float32; the kernel k stays float32 (the
  unrouted conv would round it to bf16);
- the nine-tap sum in float32, row tap outer, column tap inner; the output
  cast once to x's dtype;
- dx in x's dtype: for stride 1 the forward of the cotangent with the
  kernel flipped, for stride 2 the sum of the taps that read each input
  pixel in the same order, each product and sum rounded on its own;
- dk a float32 sum over every output pixel, returned in k's dtype.

On the card the backward, at either stride, is one kernel that reads x
and the cotangent once and writes dx and each block's dk sums, then a
fixed-order sum of the blocks' rows (`csrc/depthwise.cu`,
`dw_bwd_s2_kernel` and `dw_bwd_s1_kernel`).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from torch_semantic_segmentation_tpu_torch import kernels
from torch_semantic_segmentation_tpu_torch.ops.mbconv import _out_size, _windows

_DTYPES = (torch.bfloat16, torch.float32)


def supports(x_shape, stride: int, dilation: int = 1,
             dtype: torch.dtype = torch.bfloat16) -> bool:
    """Which depthwise convs the routed path takes: the JAX package's
    `pallas_dw.supports`, so that both packages route the same convs.

    The width conditions are a parity-only rule: they come from the TPU
    kernel's W-packed layout (P = 128 / gcd(C, 128) pixels a lane row),
    and the CUDA kernels take any W and C up to 2048. They go when routing
    parity with the JAX package, and the tests that compare the two
    packages' routed paths, no longer hold."""
    if dilation != 1 or stride not in (1, 2) or dtype not in _DTYPES:
        return False
    n, h, w, c = x_shape
    p = 128 // math.gcd(c, 128)
    if w % p:
        return False
    if stride == 2:
        return h % 2 == 0 and (w // p) % 2 == 0
    return True


def depthwise3x3_reference(x: torch.Tensor, k: torch.Tensor,
                           stride: int) -> torch.Tensor:
    """Plain PyTorch forward. x (N,H,W,C); k (3,3,C). Returns (N,Ho,Wo,C) in
    x's dtype."""
    n, h, w, c = x.shape
    ho, wo = _out_size(h, stride), _out_size(w, stride)
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    kf = k.float()
    acc = torch.zeros((n, ho, wo, c), dtype=torch.float32, device=x.device)
    for dh, dw, win in _windows(xp, ho, wo, stride):
        acc = acc + win * kf[dh, dw]
    return acc.to(x.dtype)


def depthwise3x3_reference_backward(x: torch.Tensor, k: torch.Tensor,
                                    g: torch.Tensor, stride: int):
    """Plain PyTorch backward at the kernels' rounding points: the
    cotangent g (N,Ho,Wo,C) → (dx in x's dtype, dk (3,3,C) float32)."""
    n, h, w, c = x.shape
    ho, wo = _out_size(h, stride), _out_size(w, stride)
    g = g.to(x.dtype)
    if stride == 1:
        dx = depthwise3x3_reference(g, k.flip(0, 1), 1)
    else:
        gf, kf = g.float(), k.float()
        dxp = torch.zeros((n, h + 2, w + 2, c), dtype=torch.float32,
                          device=x.device)
        # each padded pixel gathers its taps in (dh, dw) order, as the
        # kernel's gather form does
        for dh, dw, win in _windows(dxp, ho, wo, stride):
            win += gf * kf[dh, dw]              # a view: scatters into dxp
        dx = dxp[:, 1:h + 1, 1:w + 1, :].to(x.dtype)
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    gf = g.float()
    dk = torch.zeros((3, 3, c), dtype=torch.float32, device=x.device)
    for dh, dw, win in _windows(xp, ho, wo, stride):
        dk[dh, dw] = (win * gf).sum(dim=(0, 1, 2))
    return dx, dk


def _library() -> ctypes.CDLL:
    lib = kernels.load("depthwise")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dw3x3_forward.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
        lib.dw3x3_backward.argtypes = [p, p, p, p, p, ll, p, i, i, i, i, i,
                                       i, i, p]
        for name in ("dw3x3_forward", "dw3x3_backward"):
            getattr(lib, name).restype = i
        lib.dw3x3_backward_plan.argtypes = [i, i, i, i, i, i, i, p]
        lib.dw3x3_backward_plan.restype = ll
        lib.dw3x3_max_channels.argtypes = []
        lib.dw3x3_max_channels.restype = i
        lib.dw3x3_error_string.argtypes = [i]
        lib.dw3x3_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_cuda_inputs(lib, x: torch.Tensor, k: torch.Tensor, stride: int):
    if x.dtype not in _DTYPES:
        raise TypeError(f"depthwise kernel takes bfloat16 or float32 x, got "
                        f"{x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("depthwise kernel takes a contiguous NHWC tensor")
    if stride not in (1, 2):
        raise ValueError(f"depthwise kernel takes stride 1 or 2, got {stride}")
    c = x.shape[-1]
    if c > lib.dw3x3_max_channels():
        raise ValueError(f"depthwise kernel takes C <= "
                         f"{lib.dw3x3_max_channels()}, got {c}")
    if tuple(k.shape) != (3, 3, c):
        raise ValueError(f"depthwise kernel: k of shape {tuple(k.shape)}, "
                         f"expected {(3, 3, c)}")
    if k.device != x.device:
        raise ValueError(f"depthwise kernel: all tensors must be on "
                         f"{x.device}, got k on {k.device}")


def _check(lib, err: int, what: str):
    if err != 0:
        raise RuntimeError(f"depthwise {what} kernel launch failed: "
                           + lib.dw3x3_error_string(err).decode())


def _launch_args(x: torch.Tensor) -> tuple[int, int, int]:
    """(is_bf16, device index, stream) of a launch on x's device."""
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return int(x.dtype == torch.bfloat16), x.device.index or 0, stream


@functools.lru_cache(maxsize=64)
def _bwd_rows(n: int, h: int, w: int, c: int, stride: int, is_bf16: int,
              device: int) -> int:
    """Rows of the backward's dk scratch: its blocks, which the card's
    occupancy fixes for a shape and stride."""
    rows = _library().dw3x3_backward_plan(n, h, w, c, stride, is_bf16,
                                          device, None)
    if rows < 0:
        raise RuntimeError(f"depthwise backward: no launch plan for "
                           f"{(n, h, w, c)}")
    return rows


def depthwise3x3_forward(x: torch.Tensor, k: torch.Tensor,
                         stride: int) -> torch.Tensor:
    """The forward: kernel on the card, `depthwise3x3_reference` on the
    CPU."""
    if x.device.type == "cpu":
        return depthwise3x3_reference(x, k, stride)
    if x.device.type != "cuda":
        raise ValueError(f"depthwise: no kernel for device {x.device}")
    lib = _library()
    _check_cuda_inputs(lib, x, k, stride)
    n, h, w, c = x.shape
    kf = k.float().contiguous()
    y = torch.empty((n, _out_size(h, stride), _out_size(w, stride), c),
                    dtype=x.dtype, device=x.device)
    _check(lib, lib.dw3x3_forward(x.data_ptr(), kf.data_ptr(), y.data_ptr(),
                                  n, h, w, c, stride, *_launch_args(x)),
           "forward")
    depthwise3x3_forward.launches += 1
    kernels.check_finite("depthwise forward", y)
    return y


depthwise3x3_forward.launches = 0


def depthwise3x3_backward(x: torch.Tensor, k: torch.Tensor, g: torch.Tensor,
                          stride: int):
    """The backward: (dx in x's dtype, dk (3,3,C) float32) from the
    cotangent g; the plain version on the CPU. On the card, either stride:
    one kernel for dx and the blocks' dk sums, then their sum. dk is the
    same bit for bit from launch to launch."""
    if x.device.type == "cpu":
        return depthwise3x3_reference_backward(x, k, g, stride)
    if x.device.type != "cuda":
        raise ValueError(f"depthwise: no kernel for device {x.device}")
    lib = _library()
    _check_cuda_inputs(lib, x, k, stride)
    n, h, w, c = x.shape
    ho, wo = _out_size(h, stride), _out_size(w, stride)
    if tuple(g.shape) != (n, ho, wo, c) or g.device != x.device:
        raise ValueError(f"depthwise backward: cotangent {tuple(g.shape)} on "
                         f"{g.device}, expected {(n, ho, wo, c)} on {x.device}")
    g = g.to(x.dtype).contiguous()
    args = _launch_args(x)
    kf = k.float().contiguous()
    dx = torch.empty_like(x)
    dk = torch.empty((3, 3, c), dtype=torch.float32, device=x.device)
    rows = _bwd_rows(n, h, w, c, stride, *args[:2])
    scratch = torch.empty((rows, 9, c), dtype=torch.float32, device=x.device)
    _check(lib, lib.dw3x3_backward(
        x.data_ptr(), g.data_ptr(), kf.data_ptr(), dx.data_ptr(),
        scratch.data_ptr(), rows, dk.data_ptr(), n, h, w, c, stride, *args),
        "backward")
    depthwise3x3_backward.launches += 1
    kernels.check_finite("depthwise backward", dx, dk)
    return dx, dk


depthwise3x3_backward.launches = 0


class _Depthwise3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, stride):
        ctx.stride = stride
        ctx.save_for_backward(x, k)
        return depthwise3x3_forward(x, k, stride)

    @staticmethod
    def backward(ctx, g):
        x, k = ctx.saved_tensors
        dx, dk = depthwise3x3_backward(x, k, g, ctx.stride)
        return dx, dk.to(k.dtype), None


def depthwise_conv3x3(x: torch.Tensor, k: torch.Tensor,
                      stride: int) -> torch.Tensor:
    """Depthwise 3×3, zero padding 1, no bias. x (N,H,W,C) bf16 or float32,
    contiguous; k (3,3,C). Returns (N,Ho,Wo,C) in x's dtype,
    Ho = (H−1)//stride + 1."""
    return _Depthwise3x3.apply(x, k, stride)
