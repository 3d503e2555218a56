"""Fused expand 1×1 (train-mode BN folded in) → ReLU → depthwise 3×3, with
its Hopper kernels, forward and backward.

    y = dw3×3_s( bf16( relu(x·W′ + b′) ) ),  s ∈ {1, 2}, zero padding 1

`fused_expand_dw` is an autograd function. Its forward calls
`expand_dw_forward` and its backward `expand_dw_backward`; each launches
its CUDA kernel (`csrc/mbconv.cu`) for tensors on the card and runs the
plain PyTorch version for tensors on the CPU. They replace the JAX
package's Pallas kernels `ops/pallas_mbconv.py::_fwd_kernel` and
`::_bwd_kernel`. Only x, W′, b′ and k are saved for the backward: the
6×-wide expanded tensor `e` is never stored, forward or backward.

Rounding points, the TPU kernel's:
- forward: `e = bf16(relu(bf16(x)·bf16(W′) + b′))` with float32
  accumulation; taps rounded to bf16; products and the nine-tap sum in
  float32 (row tap outer, column tap inner); output in bf16;
- backward: taps in float32; `de` in float32, masked by `e > 0` (`dem`);
  `dx = bf16(dem)·bf16(W′)ᵀ` in x's dtype; `dW′ = Σ bf16(x)ᵀ·bf16(dem)`,
  `db′ = Σ dem` and `dk = Σ g ⊙ shifted e`, all in float32.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from torch_semantic_segmentation_tpu_torch import kernels


_MAX_CIN = 128   # the backward holds dx for up to 8 column tiles a warp
_suppressed = 0  # depth of open `suppress_routing` blocks


@contextlib.contextmanager
def suppress_routing():
    """Within the block no inverted residual routes to `fused_expand_dw`:
    its expand and depthwise run as the plain conv layers (the JAX
    package's `pallas_mbconv.suppress_routing`, which a rematerialised
    train step opens around its forward)."""
    global _suppressed
    _suppressed += 1
    try:
        yield
    finally:
        _suppressed -= 1


def routing_suppressed() -> bool:
    return _suppressed > 0


def _out_size(n: int, stride: int) -> int:
    return (n + 2 - 3) // stride + 1


def _expand(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            exact: bool = False) -> torch.Tensor:
    """e = bf16(relu(bf16(x)·bf16(W′) + b′)) as float32 values. A product of
    two bf16 values is exact in float32, so the float32 matmul is the
    bf16 product with float32 accumulation. With `exact` the pre-activation
    is summed in float64 and rounded to float32 once, so that e > 0 follows
    its exact sign, as in the backward kernel: a float32 sum in another
    order may put an element within its rounding error of 0 on the other
    side, and the mask then moves all of that element's de."""
    if exact:
        acc = (x.to(torch.bfloat16).double() @ w.to(torch.bfloat16).double()
               + b.double()).float()
    else:
        acc = x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float() \
            + b.float()
    return F.relu(acc).to(torch.bfloat16).float()


def _windows(ep: torch.Tensor, ho: int, wo: int, stride: int):
    """The nine (dh, dw) views of a zero-padded NHWC tensor that line up with
    the (ho, wo) output grid."""
    for dh in range(3):
        for dw in range(3):
            yield dh, dw, ep[:, dh:dh + stride * (ho - 1) + 1:stride,
                             dw:dw + stride * (wo - 1) + 1:stride, :]


def expand_dw_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        k: torch.Tensor, stride: int) -> torch.Tensor:
    """Plain PyTorch forward. x (N,H,W,Cin); w (Cin,Ce); b (Ce,); k (3,3,Ce).
    Returns (N,Ho,Wo,Ce) in bf16."""
    n, h, wd, _ = x.shape
    ho, wo = _out_size(h, stride), _out_size(wd, stride)
    ep = F.pad(_expand(x, w, b), (0, 0, 1, 1, 1, 1))
    kb = k.to(torch.bfloat16).float()
    acc = torch.zeros((n, ho, wo, w.shape[1]), dtype=torch.float32,
                      device=x.device)
    for dh, dw, win in _windows(ep, ho, wo, stride):
        acc = acc + win * kb[dh, dw]
    return acc.to(torch.bfloat16)


def expand_dw_reference_backward(x, w, b, k, g, stride: int):
    """Plain PyTorch backward at the kernel's rounding points: the cotangent
    g (N,Ho,Wo,Ce) → (dx in x's dtype, dW′, db′, dk in float32). The mask
    e > 0 follows the exact pre-activation's sign (`_expand`)."""
    n, h, wd, c_in = x.shape
    ce = w.shape[1]
    ho, wo = _out_size(h, stride), _out_size(wd, stride)
    e = _expand(x, w, b, exact=True)
    gf = g.float()
    kf = k.float()
    dep = torch.zeros((n, h + 2, wd + 2, ce), dtype=torch.float32,
                      device=x.device)
    ep = F.pad(e, (0, 0, 1, 1, 1, 1))
    dk = torch.zeros((3, 3, ce), dtype=torch.float32, device=x.device)
    for dh, dw, win in _windows(dep, ho, wo, stride):
        win += gf * kf[dh, dw]              # a view: scatters into dep
    for dh, dw, win in _windows(ep, ho, wo, stride):
        dk[dh, dw] = (gf * win).sum(dim=(0, 1, 2))
    dem = dep[:, 1:h + 1, 1:wd + 1, :] * (e > 0)
    demb = dem.to(torch.bfloat16).float().reshape(-1, ce)
    dx = (demb @ w.to(torch.bfloat16).float().t()).to(x.dtype)
    xb = x.to(torch.bfloat16).float().reshape(-1, c_in)
    dw_ = xb.t() @ demb
    db = dem.sum(dim=(0, 1, 2))
    return dx.reshape(x.shape), dw_, db, dk


def _library() -> ctypes.CDLL:
    lib = kernels.load("mbconv")
    if not getattr(lib, "_typed", False):
        p, i, z = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        lib.mbconv_forward.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.mbconv_forward.restype = i
        lib.mbconv_backward.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i, i,
                                        i, i, i, i, i, i, p]
        lib.mbconv_backward.restype = i
        lib.mbconv_bwd_groups.argtypes = [i, i, i, i, i, i, i]
        lib.mbconv_bwd_groups.restype = i
        for name in ("mbconv_fwd_smem", "mbconv_bwd_smem"):
            getattr(lib, name).argtypes = [i, i]
            getattr(lib, name).restype = z
        lib.mbconv_smem_limit.argtypes = []
        lib.mbconv_smem_limit.restype = z
        lib.mbconv_error_string.argtypes = [i]
        lib.mbconv_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_cuda_inputs(x, w, b, k, stride):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"mbconv kernel takes bfloat16 x, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("mbconv kernel takes a contiguous NHWC tensor")
    if stride not in (1, 2):
        raise ValueError(f"mbconv kernel takes stride 1 or 2, got {stride}")
    c_in, ce = x.shape[-1], w.shape[-1]
    if c_in > _MAX_CIN:
        raise ValueError(f"mbconv kernel takes Cin <= {_MAX_CIN}, got {c_in}")
    for t, want in ((w, (c_in, ce)), (b, (ce,)), (k, (3, 3, ce))):
        if tuple(t.shape) != want:
            raise ValueError(f"mbconv kernel: shape {tuple(t.shape)}, "
                             f"expected {want}")
        if t.device != x.device:
            raise ValueError("mbconv kernel: all tensors must be on "
                             f"{x.device}, got one on {t.device}")


def _check(lib, err: int, what: str):
    if err != 0:
        raise RuntimeError(f"mbconv {what} kernel launch failed: "
                           + lib.mbconv_error_string(err).decode())


def _check_smem(lib, need: int, what: str):
    if need == 0 or need > lib.mbconv_smem_limit():
        raise ValueError(f"mbconv {what} kernel: the block's shared memory "
                         f"({need} bytes) exceeds the card's limit")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def expand_dw_forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      k: torch.Tensor, stride: int) -> torch.Tensor:
    """The forward: kernel on the card, `expand_dw_reference` on the CPU."""
    if x.device.type == "cpu":
        return expand_dw_reference(x, w, b, k, stride)
    if x.device.type != "cuda":
        raise ValueError(f"mbconv: no kernel for device {x.device}")
    _check_cuda_inputs(x, w, b, k, stride)
    n, h, wd, c_in = x.shape
    ce = w.shape[1]
    lib = _library()
    _check_smem(lib, lib.mbconv_fwd_smem(c_in, stride), "forward")
    wb = w.to(torch.bfloat16).contiguous()
    bf = b.float().contiguous()
    kf = k.float().contiguous()
    out = torch.empty((n, _out_size(h, stride), _out_size(wd, stride), ce),
                      dtype=torch.bfloat16, device=x.device)
    _check(lib, lib.mbconv_forward(
        x.data_ptr(), wb.data_ptr(), bf.data_ptr(), kf.data_ptr(),
        out.data_ptr(), n, h, wd, c_in, ce, stride, x.device.index or 0,
        _stream(x)), "forward")
    expand_dw_forward.launches += 1
    kernels.check_finite("mbconv forward", out)
    return out


expand_dw_forward.launches = 0


def expand_dw_backward(x, w, b, k, g, stride: int):
    """The backward: (dx, dW′, db′, dk) from the cotangent g; the kernel on
    the card (dW′, db′ and dk summed with float32 atomics; where Ce is split
    over groups of chunks, a float32 scratch of the groups' partials of dx
    that a second kernel sums in order), the plain version on the CPU."""
    if x.device.type == "cpu":
        return expand_dw_reference_backward(x, w, b, k, g, stride)
    if x.device.type != "cuda":
        raise ValueError(f"mbconv: no kernel for device {x.device}")
    _check_cuda_inputs(x, w, b, k, stride)
    n, h, wd, c_in = x.shape
    ce = w.shape[1]
    ho, wo = _out_size(h, stride), _out_size(wd, stride)
    if tuple(g.shape) != (n, ho, wo, ce) or g.device != x.device:
        raise ValueError(f"mbconv backward: cotangent {tuple(g.shape)} on "
                         f"{g.device}, expected {(n, ho, wo, ce)} on {x.device}")
    lib = _library()
    g = g.to(torch.bfloat16).contiguous()
    wb = w.to(torch.bfloat16).contiguous()
    bf = b.float().contiguous()
    kf = k.float().contiguous()
    wn = torch.linalg.vector_norm(wb, dim=0, dtype=torch.float32)
    _check_smem(lib, lib.mbconv_bwd_smem(c_in, stride), "backward")
    dev = x.device.index or 0
    groups = lib.mbconv_bwd_groups(n, h, wd, c_in, ce, stride, dev)
    if groups < 1:
        raise RuntimeError("mbconv backward: no launch configuration for "
                           f"{tuple(x.shape)}x{ce} at stride {stride}")
    dx = torch.empty_like(x)
    part = (torch.empty((groups, n, h, wd, c_in), dtype=torch.float32,
                        device=x.device) if groups > 1 else None)
    zeros = dict(dtype=torch.float32, device=x.device)
    dw_ = torch.zeros((c_in, ce), **zeros)
    db = torch.zeros((ce,), **zeros)
    dk = torch.zeros((3, 3, ce), **zeros)
    _check(lib, lib.mbconv_backward(
        x.data_ptr(), wb.data_ptr(), bf.data_ptr(), kf.data_ptr(),
        wn.data_ptr(), g.data_ptr(), dx.data_ptr(),
        None if part is None else part.data_ptr(), dw_.data_ptr(), db.data_ptr(), dk.data_ptr(), n, h, wd, c_in, ce,
        stride, groups, dev, _stream(x)), "backward")
    expand_dw_backward.launches += 1
    kernels.check_finite("mbconv backward", dx, dw_, db, dk)
    return dx, dw_, db, dk


expand_dw_backward.launches = 0


class _FusedExpandDw(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, k, stride):
        ctx.stride = stride
        ctx.save_for_backward(x, w, b, k)
        return expand_dw_forward(x, w, b, k, stride)

    @staticmethod
    def backward(ctx, g):
        x, w, b, k = ctx.saved_tensors
        dx, dw, db, dk = expand_dw_backward(x, w, b, k, g, ctx.stride)
        return dx, dw.to(w.dtype), db.to(b.dtype), dk.to(k.dtype), None


def fused_expand_dw(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    k: torch.Tensor, stride: int) -> torch.Tensor:
    """dw3×3_stride(relu(x·w + b)) with the expanded tensor never stored.

    x (N,H,W,Cin) bf16; w (Cin,Ce) folded expand weights; b (Ce,) folded
    bias; k (3,3,Ce) depthwise taps, zero padding 1. Returns
    (N,Ho,Wo,Ce) bf16, Ho = (H−1)//stride + 1."""
    return _FusedExpandDw.apply(x, w, b, k, stride)
