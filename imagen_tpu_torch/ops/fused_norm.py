"""Fused transformer feedforward: kernel 3 of the port.

Counterpart of `fused_feedforward` in `imagen_tpu/ops/fused_norm.py`:
LayerNorm -> Linear -> exact GELU -> LayerNorm -> Linear, no biases. The CUDA
kernel is `csrc/fused_feedforward.cu`; its header says what bounds it on the
H100 and how its design answers that.

Weights are in the torch Linear layout of `models.blocks.FeedForward`:
w0 (hid, k), w1 (k, hid); g0 (k,), g1 (hid,) are the LayerNorm gains.

On a CPU tensor `fused_feedforward` runs `feedforward_reference`, the plain
PyTorch version (`_ff_xla` of the JAX package). On a CUDA tensor it launches
the kernel or raises.

When a gradient is wanted the call is an autograd Function whose backward is
the JAX package's (`_ff_bwd`): the plain chain recomputed and differentiated
by autograd, so only the inputs are kept between forward and backward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from imagen_tpu_torch.ops import _build
from imagen_tpu_torch.ops.tensor_utils import wants_grad

KERNEL = 'fused_feedforward_bf16'
_FF_WEIGHT_BUDGET = 4 * 1024 * 1024
_SMEM_LIMIT = 227 * 1024


def _ff_rows_block(rows, k, hid):
    for bm in (512, 256, 128, 64, 32, 16, 8):
        if rows % bm == 0 and bm * (k + hid) * 4 <= 6 * 1024 * 1024:
            return bm
    return None


def fused_feedforward_available(rows, k, hid, dtype=torch.bfloat16, device_type='cuda'):
    """The shape gate of `fused_feedforward_available` in the JAX package.

    The CUDA kernel takes bf16 only, so a CUDA tensor of another dtype stays
    on the module's unfused chain.
    """
    itemsize = torch.empty((), dtype=dtype).element_size()
    return (k % 128 == 0 and hid % 128 == 0
            and 2 * k * hid * itemsize <= _FF_WEIGHT_BUDGET
            and _ff_rows_block(rows, k, hid) is not None
            and (device_type == 'cpu' or dtype == torch.bfloat16))


def layernorm(t, g, eps):
    """Bias-free LayerNorm of `models.blocks.LayerNorm` (stable=False)."""
    dtype = t.dtype
    tf = t.to(torch.promote_types(dtype, torch.float32))
    var = tf.var(dim=-1, unbiased=False, keepdim=True).to(dtype)
    mean = tf.mean(dim=-1, keepdim=True).to(dtype)
    return (t - mean) * torch.rsqrt(var + eps).to(dtype) * g.to(dtype)


def feedforward_reference(x, g0, w0, g1, w1, eps):
    """Plain version: the module chain, each product in x's dtype."""
    h = layernorm(x, g0, eps)
    h = F.linear(h, w0.to(h.dtype))
    h = F.gelu(h)
    h = layernorm(h, g1, eps)
    return F.linear(h, w1.to(h.dtype))


def _ff_forward(x, g0, w0, g1, w1, eps):
    if x.device.type == 'cpu':
        return feedforward_reference(x, g0, w0, g1, w1, eps)
    if not x.is_cuda or w0.device != x.device or w1.device != x.device:
        raise ValueError('fused_feedforward: x and weights must share one CUDA device')
    if x.dtype != torch.bfloat16:
        raise TypeError(f'fused_feedforward kernel takes bf16, got {x.dtype}')
    shape = x.shape
    k = shape[-1]
    hid = w0.shape[0]
    if tuple(w0.shape) != (hid, k) or tuple(w1.shape) != (k, hid):
        raise ValueError(f'weights {tuple(w0.shape)}, {tuple(w1.shape)} do not fit k={k}')
    if k % 16 or hid % 16:
        raise ValueError(f'fused_feedforward kernel needs k, hid % 16 == 0, got {k}, {hid}')
    if 16 * (k + hid) * 2 + 8 * 1024 > _SMEM_LIMIT:
        raise ValueError(f'fused_feedforward: k={k}, hid={hid} exceed shared memory')
    x2 = x.reshape(-1, k).contiguous()
    rows = x2.shape[0]
    g0f, g1f = g0.float().contiguous(), g1.float().contiguous()
    w0c, w1c = w0.to(x.dtype).contiguous(), w1.to(x.dtype).contiguous()
    out = torch.empty_like(x2)
    _build.launch(KERNEL, x2.data_ptr(), g0f.data_ptr(), w0c.data_ptr(), g1f.data_ptr(),
                  w1c.data_ptr(), out.data_ptr(), rows, k, hid, float(eps))
    return out.reshape(shape)


class _FusedFeedForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g0, w0, g1, w1, eps):
        ctx.save_for_backward(x, g0, w0, g1, w1)
        ctx.eps = eps
        return _ff_forward(x, g0, w0, g1, w1, eps)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
            out = feedforward_reference(*inputs, ctx.eps)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(grads) if t.requires_grad else None for t in inputs), None)


def fused_feedforward(x, g0, w0, g1, w1, eps):
    """x (..., k) -> (..., k)."""
    if wants_grad(x, g0, w0, g1, w1):
        return _FusedFeedForward.apply(x, g0, w0, g1, w1, eps)
    return _ff_forward(x, g0, w0, g1, w1, eps)
