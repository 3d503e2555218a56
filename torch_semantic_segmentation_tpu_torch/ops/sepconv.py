"""Fused depthwise-separable conv (dw 3×3 → bias → ReLU → pw 1×1 → bias →
ReLU) for the folded-BN inference path, with its Hopper kernel.

`fused_separable_conv` launches the CUDA kernel `csrc/sepconv.cu` for a
tensor on the card and runs the plain PyTorch version
`separable_conv_reference` for a tensor on the CPU; on any other device, or
for inputs the kernel does not take, it raises. It replaces the JAX
package's Pallas kernel `ops/pallas_sepconv.py::_kernel`.

`fuse_conv_pair` routes a folded (depthwise ConvBNAct, 1×1 ConvBNAct) pair
to it, with the JAX package's applicability rules: stride-1 3×3 depthwise
with padding equal to its dilation, both convs with a bias, no BN left,
ReLU or identity activations. On FastSCNN's serving path that is the
Classifier's `ds1` and `ds2` and the FFM's dilated dw → `low_proj`. The
weights in the kernel's layouts are made once and kept on the pair while
its parameters are unchanged (`_kernel_weights`), so a fused call there is
one launch.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from torch_semantic_segmentation_tpu_torch import kernels
from torch_semantic_segmentation_tpu_torch.parallel import distributed

_SUPPORTED = (torch.float32, torch.bfloat16)


def separable_conv_reference(x: torch.Tensor, dw_kernel: torch.Tensor,
                             dw_bias: torch.Tensor, pw_kernel: torch.Tensor,
                             pw_bias: torch.Tensor, *, stride: int = 1,
                             dilation: int = 1, relu_mid: bool = True,
                             relu_out: bool = True) -> torch.Tensor:
    """Plain PyTorch version: float32 depthwise conv → bias → ReLU → round
    to x's dtype → 1×1 with float32 accumulation → bias → ReLU.

    x (N,H,W,C); dw_kernel (3,3,C); dw_bias (C,); pw_kernel (C,Co);
    pw_bias (Co,). Returns (N,H',W',Co) in x's dtype."""
    c = x.shape[-1]
    dwk = dw_kernel.float().permute(2, 0, 1).unsqueeze(1)     # (C,1,3,3)
    y = F.conv2d(x.float().permute(0, 3, 1, 2), dwk, dw_bias.float(),
                 stride=stride, padding=dilation, dilation=dilation, groups=c)
    y = y.permute(0, 2, 3, 1)
    if relu_mid:
        y = F.relu(y)
    # the mid value rounds to x's dtype; a product of two bf16 values is
    # exact in float32, so a float32 matmul is the float32-accumulated one
    y = y.to(x.dtype).float() @ pw_kernel.float() + pw_bias.float()
    if relu_out:
        y = F.relu(y)
    return y.to(x.dtype)


def _check_cuda_inputs(x, dw_kernel, dw_bias, pw_kernel, pw_bias, stride,
                       dilation):
    if x.dtype not in _SUPPORTED:
        raise TypeError(f"sepconv kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("sepconv kernel takes a contiguous NHWC tensor")
    if stride != 1:
        raise ValueError(f"sepconv kernel takes stride 1, got {stride}")
    if dilation < 1:
        raise ValueError(f"dilation must be >= 1, got {dilation}")
    c, co = x.shape[-1], pw_kernel.shape[-1]
    shapes = ((dw_kernel, (3, 3, c)), (dw_bias, (c,)), (pw_kernel, (c, co)),
              (pw_bias, (co,)))
    for t, want in shapes:
        if tuple(t.shape) != want:
            raise ValueError(f"sepconv kernel: shape {tuple(t.shape)}, "
                             f"expected {want}")
        if t.device != x.device:
            raise ValueError("sepconv kernel: all tensors must be on "
                             f"{x.device}, got one on {t.device}")
    if pw_kernel.dtype != x.dtype:
        raise TypeError(f"sepconv kernel: pw kernel is {pw_kernel.dtype}, "
                        f"x is {x.dtype}")


def _library() -> ctypes.CDLL:
    lib = kernels.load("sepconv")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sepconv_forward.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                        i, i, i, i, p]
        lib.sepconv_forward.restype = ctypes.c_int
        lib.sepconv_smem_bytes.argtypes = [i, i, i, i]
        lib.sepconv_smem_bytes.restype = ctypes.c_size_t
        lib.sepconv_error_string.argtypes = [i]
        lib.sepconv_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def fused_separable_conv(x: torch.Tensor, dw_kernel: torch.Tensor,
                         dw_bias: torch.Tensor, pw_kernel: torch.Tensor,
                         pw_bias: torch.Tensor, *, stride: int = 1,
                         dilation: int = 1, relu_mid: bool = True,
                         relu_out: bool = True) -> torch.Tensor:
    """Fused folded-BN depthwise-separable conv; arguments as for
    `separable_conv_reference`. On the card the kernel takes stride 1,
    float32 or bfloat16 x and a pw kernel of x's dtype."""
    if x.device.type == "cpu":
        return separable_conv_reference(
            x, dw_kernel, dw_bias, pw_kernel, pw_bias, stride=stride,
            dilation=dilation, relu_mid=relu_mid, relu_out=relu_out)
    if x.device.type != "cuda":
        raise ValueError(f"sepconv: no kernel for device {x.device}")
    _check_cuda_inputs(x, dw_kernel, dw_bias, pw_kernel, pw_bias, stride,
                       dilation)
    n, h, w, c = x.shape
    co = pw_kernel.shape[-1]
    is_bf16 = int(x.dtype == torch.bfloat16)
    lib = _library()
    if lib.sepconv_smem_bytes(c, co, dilation, is_bf16) == 0:
        raise ValueError(f"sepconv kernel: C={c}, Co={co}, dilation "
                         f"{dilation} exceed the block's shared memory")
    dwk = dw_kernel.float().contiguous()
    dwb = dw_bias.float().contiguous()
    pwk = pw_kernel.contiguous()
    pwb = pw_bias.float().contiguous()
    out = torch.empty((n, h, w, co), dtype=x.dtype, device=x.device)
    err = lib.sepconv_forward(
        x.data_ptr(), dwk.data_ptr(), dwb.data_ptr(), pwk.data_ptr(),
        pwb.data_ptr(), out.data_ptr(), n, h, w, c, co, dilation,
        int(relu_mid), int(relu_out), is_bf16, x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("sepconv kernel launch failed: "
                           + lib.sepconv_error_string(err).decode())
    fused_separable_conv.launches += 1
    kernels.check_finite("sepconv", out)
    return out


fused_separable_conv.launches = 0


def fuse_conv_pair(dw, pw, x: torch.Tensor) -> torch.Tensor | None:
    """Run a folded (depthwise ConvBNAct, 1×1 ConvBNAct) pair as one fused
    conv. Returns None where the pair does not qualify (BN not folded,
    other activations, not a stride-1 3×3 depthwise, no bias); the caller
    then runs `pw(dw(x))`."""
    if dw.bn is not None or pw.bn is not None:
        return None  # BN not folded: batch stats need the dw output
    if dw.act_name not in (None, "identity", "relu"):
        return None
    if pw.act_name not in (None, "identity", "relu"):
        return None
    dwc, pwc = dw.conv, pw.conv
    c = x.shape[-1]
    d = dwc.dilation[0]
    if (tuple(dwc.weight.shape) != (c, 1, 3, 3)
            or dwc.groups != c
            or dwc.stride != (1, 1)
            or dwc.dilation != (d, d)
            or dwc.padding != (d, d)
            or dwc.bias is None or pwc.bias is None):
        return None
    if (tuple(pwc.weight.shape[1:]) != (c, 1, 1) or pwc.stride != (1, 1)
            or pwc.padding != (0, 0) or pwc.groups != 1):
        return None
    weights = _kernel_weights(dw, pw, x.dtype)
    # on an H band: band + d halo rows each side, cropped
    return distributed.on_band(lambda xh: fused_separable_conv(
        xh.contiguous(), *weights, stride=1, dilation=d,
        relu_mid=dw.act_name == "relu",
        relu_out=pw.act_name == "relu",
    ), x, d, d)


def _kernel_weights(dw, pw, dtype: torch.dtype) -> tuple:
    """The pair's weights as the kernel takes them: dw taps (3,3,C) and
    bias float32, pw (C,Co) in `dtype`, pw bias float32, all contiguous.

    Made once and kept on `pw` for as long as the four parameters are the
    same tensors with the same data and version: an in-place update, an
    optimizer step, `load_state_dict` and `.to` each change one of these,
    so the kept copy is never stale (an update through `.data` bypasses the
    version counter and is not seen). Where autograd records through the
    parameters they are made anew on every call, so gradients reach them."""
    dwc, pwc = dw.conv, pw.conv
    params = (dwc.weight, dwc.bias, pwc.weight, pwc.bias)
    stamp = (dtype, tuple(t._version for t in params),
             tuple(t.data_ptr() for t in params))
    record = torch.is_grad_enabled() and any(t.requires_grad for t in params)
    kept = getattr(pw, "_sepconv_weights", None)
    if (not record and kept is not None and kept[0] == stamp
            and all(a is b for a, b in zip(kept[1], params))):
        return kept[2]
    c = dwc.weight.shape[0]
    # ordinary tensors even under inference_mode, so that a later call
    # outside it may use them
    with torch.inference_mode(False), torch.set_grad_enabled(record):
        weights = (dwc.weight.reshape(c, 3, 3).permute(1, 2, 0).float()
                   .contiguous(),
                   dwc.bias.float().contiguous(),
                   pwc.weight.reshape(-1, c).t().to(dtype).contiguous(),
                   pwc.bias.float().contiguous())
    if not record:
        pw._sepconv_weights = (stamp, params, weights)
    return weights
