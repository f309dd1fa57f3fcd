"""The CrossEmbed stem in one pass: kernel 14 of the port.

Counterpart of `cross_embed_stem` in `imagen_tpu/ops/stem_conv.py`: every
scale of a stride-1 `CrossEmbedLayer` (a SAME conv per kernel size, the
channels split between the scales), concatenated, plus the bias.

    x (b, H, W, c), ws [(k_i, k_i, c, d_i)], bias (sum d_i,) -> (b, H, W, sum d_i)

The CUDA kernel is `csrc/cross_embed_stem.cu`; its header says what bounds
it on the H100 and how its design answers that. The TPU kernel's 4x4
space-to-depth copy of the input existed to feed the MXU and is not carried
over.

On a CPU tensor `cross_embed_stem` runs `cross_embed_stem_reference`, the
plain version (the JAX package's `_xla_reference`). On a CUDA tensor it
launches the kernel or raises. When a gradient is wanted the call is an
autograd Function whose backward is the JAX package's `_bwd`: the VJP of
the plain version, recomputed from the saved inputs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from imagen_tpu_torch.ops import _build
from imagen_tpu_torch.ops.fused_norm import recomputed_grads
from imagen_tpu_torch.ops.tensor_utils import wants_grad

KERNEL = 'cross_embed_stem_bf16'
MAX_SCALES = 4      # the C entry point takes up to four (k, d) pairs
MAX_KERNEL = 15     # a scale's 32-channel weight chunk sits in shared memory whole
CHUNK = 32          # output channels of a scale per block


def stem_available(x_shape, kernel_sizes, dtype=torch.bfloat16, device_type='cuda'):
    """The shape gate of `stem_available` in the JAX package: NHWC, c * 16
    <= 128, H and W divisible by 4, odd kernels. Its backend, environment
    and row-band (`_pick_hb`) conditions are dropped; the kernel's own
    limits are added (at most 4 scales, kernels up to 15), and on CUDA the
    kernel takes bf16."""
    if len(x_shape) != 4:
        return False
    _, H, W, c = x_shape
    if c * 16 > 128 or H % 4 or W % 4:
        return False
    if any(k % 2 == 0 for k in kernel_sizes):
        return False
    if not 1 <= len(kernel_sizes) <= MAX_SCALES or max(kernel_sizes) > MAX_KERNEL:
        return False
    return device_type == 'cpu' or dtype == torch.bfloat16


def cross_embed_stem_reference(x, ws, bias):
    """Plain version (`_xla_reference`): a stride-1 SAME conv per scale in x's
    dtype, concatenated, then the bias added."""
    xc = x.permute(0, 3, 1, 2)
    ys = [F.conv2d(xc, w.to(x.dtype).permute(3, 2, 0, 1), padding=w.shape[0] // 2)
          for w in ws]
    y = torch.cat(ys, dim=1).permute(0, 2, 3, 1)
    return y + bias.to(y.dtype)


def pack_stem_weights(ws):
    """Each scale's (k, k, c, d) weight as (d / 32, k, P, 16, 32) bf16, P = (k + 1) / 2:
    per 32 output channels, row dy, tap pair q, the 16 rows of one mma step
    (taps 2q and 2q + 1, 8 channels each; the odd row's last tap, channels
    past c and outputs past d are zero), all scales one after another."""
    packed = []
    for w in ws:
        k, _, c, d = w.shape
        pairs, dp = (k + 1) // 2, -(-d // CHUNK) * CHUNK
        wp = F.pad(w.to(torch.bfloat16), (0, dp - d, 0, 8 - c, 0, 2 * pairs - k))
        wp = wp.reshape(k, pairs, 16, dp // CHUNK, CHUNK).permute(3, 0, 1, 2, 4)
        packed.append(wp.reshape(-1))
    return torch.cat(packed).contiguous()


def _stem_forward(x, bias, *ws, packed=None):
    if x.device.type == 'cpu':
        return cross_embed_stem_reference(x, ws, bias)
    if not x.is_cuda or bias.device != x.device or any(w.device != x.device for w in ws):
        raise ValueError('cross_embed_stem: tensors must share one CUDA device')
    if x.dtype != torch.bfloat16:
        raise TypeError(f'cross_embed_stem kernel takes bf16, got {x.dtype}')
    if x.ndim != 4 or x.shape[-1] > 8:
        raise ValueError(f'cross_embed_stem takes (b, H, W, c <= 8), got {tuple(x.shape)}')
    b, H, W, c = x.shape
    ks = [w.shape[0] for w in ws]
    if not 1 <= len(ws) <= MAX_SCALES or any(
            w.ndim != 4 or w.shape[1] != w.shape[0] or w.shape[2] != c for w in ws):
        raise ValueError(f'cross_embed_stem: weights {[tuple(w.shape) for w in ws]} do not '
                         f'fit input {tuple(x.shape)}')
    if any(k % 2 == 0 or k > MAX_KERNEL for k in ks):
        raise ValueError(f'cross_embed_stem kernel takes odd kernels up to {MAX_KERNEL}, '
                         f'got {ks}')
    ds = [w.shape[3] for w in ws]
    if tuple(bias.shape) != (sum(ds),):
        raise ValueError(f'cross_embed_stem: bias {tuple(bias.shape)}, expected ({sum(ds)},)')
    x = x.contiguous()
    w = pack_stem_weights(ws) if packed is None else packed
    bias = bias.to(torch.bfloat16).contiguous()
    out = torch.empty((b, H, W, sum(ds)), dtype=x.dtype, device=x.device)
    pad = MAX_SCALES - len(ws)
    _build.launch(KERNEL, x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
                  b, H, W, c, len(ws), *ks, *([0] * pad), *ds, *([0] * pad))
    return out


class _CrossEmbedStem(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias, *ws):
        ctx.save_for_backward(x, bias, *ws)
        return _stem_forward(x, bias, *ws)

    @staticmethod
    def backward(ctx, g):
        return recomputed_grads(
            ctx, lambda x, bias, *ws: cross_embed_stem_reference(x, ws, bias), g)


def cross_embed_stem(x, ws, bias, packed=None):
    """x NHWC (c <= 8); ws the scales' (k, k, c, d_i) weights, sorted like
    `CrossEmbedLayer`'s; bias (sum d_i,). `packed`, where no gradient is
    wanted, is `pack_stem_weights(ws)` made earlier; the kernel then reads it
    in place of packing ws again."""
    if wants_grad(x, bias, *ws):
        return _CrossEmbedStem.apply(x, bias, *ws)
    return _stem_forward(x, bias, *ws, packed=packed)
