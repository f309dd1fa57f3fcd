"""Stride-1 SAME 3x3 convolution, NHWC: kernel 2 of the port.

Counterpart of `conv2d_same` in `imagen_tpu/ops/conv2d.py`. The CUDA kernel
is `csrc/conv2d_same.cu`; its header says what bounds it on the H100 and how
its design answers that.

    x (b, H, W, cin), w (3, 3, cin, cout), bias (cout,) or None -> (b, H, W, cout)

On a CPU tensor `conv2d_same` runs `conv2d_same_reference`, the plain
PyTorch version (the XLA reference `_xla_reference` of the JAX package). On
a CUDA tensor it launches the kernel or raises.

When a gradient is wanted the call is an autograd Function whose backward is
the JAX package's: the linear transposes of the conv in its two factors
(`imagen_tpu/ops/conv2d.py` `_bwd`, computed by XLA there, by cuDNN's
`convolution_backward` here), with no forward recompute, and the bias
gradient as the sum of the output gradient over (b, H, W).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from imagen_tpu_torch.ops import _build
from imagen_tpu_torch.ops.tensor_utils import wants_grad

KERNEL = 'conv2d_same_3x3_bf16'


def conv2d_same_available(x_shape, w_shape, dtype=torch.bfloat16, device_type='cuda'):
    """The shape gate of `conv2d_same_available` in the JAX package.

    Its VMEM tiling condition (`_tiles_with_split`) is dropped: this kernel
    loops over cin, so every cin it admits fits. The CUDA kernel is 3x3 and
    bf16, the only conv `SameConv3x3` dispatches; a CUDA tensor of another
    dtype stays on `F.conv2d`.
    """
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    _, H, W, cin = x_shape
    kh, kw, wcin, cout = w_shape
    if kh != 3 or kw != 3 or wcin != cin:
        return False
    if cin % 128 != 0 or W % 64 != 0 or H % 8 != 0:
        return False
    dtype_ok = device_type == 'cpu' or dtype == torch.bfloat16
    if 128 * 128 <= H * W <= 1024 * 1024 and cout >= 128:
        return dtype_ok
    return dtype_ok and H * W == 64 * 64 and cin >= 1024 and cout >= 128


def conv2d_same_reference(x, w, bias):
    """Plain version: the conv in x's dtype, then the bias added."""
    k = w.shape[0]
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 padding=k // 2).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def _conv_forward(x, w, bias):
    if x.device.type == 'cpu':
        return conv2d_same_reference(x, w, bias)
    if not x.is_cuda or w.device != x.device:
        raise ValueError('conv2d_same: x and w must share one CUDA device')
    if x.dtype != torch.bfloat16:
        raise TypeError(f'conv2d_same kernel takes bf16, got {x.dtype}')
    b, H, W, cin = x.shape
    if tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f'weight {tuple(w.shape)} does not fit input {tuple(x.shape)}')
    if cin % 16 != 0:
        raise ValueError(f'conv2d_same kernel needs cin % 16 == 0, got {cin}')
    cout = w.shape[3]
    coutp = -(-cout // 8) * 8  # the kernel moves 8-channel vectors
    x = x.contiguous()
    w = F.pad(w.to(torch.bfloat16), (0, coutp - cout)).contiguous()
    if bias is not None:
        bias = F.pad(bias.to(torch.bfloat16), (0, coutp - cout)).contiguous()
    out = torch.empty((b, H, W, coutp), dtype=x.dtype, device=x.device)
    _build.launch(KERNEL, x.data_ptr(), w.data_ptr(),
                  None if bias is None else bias.data_ptr(), out.data_ptr(),
                  b, H, W, cin, coutp)
    return out if coutp == cout else out[..., :cout]


class _Conv2dSame(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        ctx.bias_dtype = None if bias is None else bias.dtype
        return _conv_forward(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        # the unpadded weight, in x's dtype as the forward used it
        wc = w.to(x.dtype).permute(3, 2, 0, 1)
        dx, dw, _ = torch.ops.aten.convolution_backward(
            g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), wc, None, [1, 1], [1, 1],
            [1, 1], False, [0, 0], 1, [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        if dx is not None:
            dx = dx.permute(0, 2, 3, 1)
        if dw is not None:
            dw = dw.permute(2, 3, 1, 0).to(w.dtype)
        db = None
        if ctx.bias_dtype is not None and ctx.needs_input_grad[2]:
            db = g.sum(dim=(0, 1, 2)).to(ctx.bias_dtype)
        return dx, dw, db


def conv2d_same(x, w, bias):
    """x NHWC, w (3, 3, cin, cout), bias (cout,) or None."""
    if wants_grad(x, w, bias):
        return _Conv2dSame.apply(x, w, bias)
    return _conv_forward(x, w, bias)
