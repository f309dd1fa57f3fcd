"""LayerNorm fused with the time-centric relayout of the video temporal path:
kernels 12 and 13 of the port.

Counterpart of `imagen_tpu/ops/temporal_layout.py`. The temporal attention
of `Unet3D` works on ((b h w), f, c) tokens, one sequence of frames per
pixel, while the U-Net keeps (b, f, h, w, c). Its unfused route pays a
relayout before the attention and one after it; these two kernels each fold
a relayout into the normalisation beside it:

  fused_ln_transpose(x, g, eps): (b, f, h, w, c) -> ((b h w), f, c),
      the bias-free LayerNorm over c (`models.blocks.LayerNorm`,
      stable=False) fused with the fold;
  fused_norm_untranspose(out, res, g, eps): ((b h w), f, c) -> (b, f, h, w, c),
      the attention's gain-only out-norm fused with the unfold and the
      temporal residual `res` (b, f, h, w, c).

The CUDA kernels are `csrc/temporal_layout.cu`; its header says what bounds
them on the H100 and how their design answers that. On a CPU tensor the
wrappers run the plain versions (`ln_transpose_reference`,
`norm_untranspose_reference`), which follow the Pallas kernels' arithmetic:
fp32 statistics, the gain (and the residual) in fp32, one rounding at the
end. On a CUDA tensor they launch the kernel or raise.

When a gradient is wanted each call is an autograd Function whose backward
differentiates the unfused chain, recomputed (`_ln_t_bwd`, `_norm_ut_bwd`
of the JAX package): permute, then `layernorm` in the input's dtype, and for
kernel 13 the residual add. Only the inputs are kept between the passes.
`TemporalAttention` calls `temporal_residual`, which decides each call's route.
"""
from __future__ import annotations

import torch

from imagen_tpu_torch.ops import _build
from imagen_tpu_torch.ops.fused_norm import layernorm, ln_eps, recomputed_grads
from imagen_tpu_torch.ops.tensor_utils import aligned_contiguous, wants_grad

LN_T_KERNEL = 'ln_transpose_bf16'
NORM_UT_KERNEL = 'norm_untranspose_bf16'
MIN_C = 128     # the JAX gate's shape class (c >= 128)
MAX_C = 2048    # one warp holds a row: 32 lanes x 8 vectors of 8 bf16


def temporal_layout_available(x_shape, dtype=torch.bfloat16, device_type='cuda'):
    """Whether a temporal site takes the fused route, on either device.

    Keeps the shape conditions of `available` in the JAX package: 5-D
    (b, f, h, w, c) input and c >= 128. Drops `_pick_hw_block`, a TPU VMEM
    tiling condition. Adds the kernels' own limits: c a multiple of 8 (16-byte
    rows), c <= 2048 (one warp per row) and, on CUDA, bf16.
    """
    if len(x_shape) != 5:
        return False
    c = x_shape[-1]
    return (MIN_C <= c <= MAX_C and c % 8 == 0
            and (device_type == 'cpu' or dtype == torch.bfloat16))


def _normalized(t, g, eps):
    """(t - mean) * rsqrt(var + eps) * g over the last axis, all in fp32."""
    tf = t.float()
    mean = tf.mean(dim=-1, keepdim=True)
    tc = tf - mean
    var = (tc * tc).mean(dim=-1, keepdim=True)
    return tc * torch.rsqrt(var + eps) * g.float()


def _fold(x):
    b, f, h, w, c = x.shape
    return x.permute(0, 2, 3, 1, 4).reshape(b * h * w, f, c)


def _unfold(y, shape):
    b, f, h, w, c = shape
    return y.reshape(b, h, w, f, c).permute(0, 3, 1, 2, 4)


def ln_transpose_reference(x, g, eps):
    """Plain version of kernel 12 (`_ln_t_kernel`): (b, f, h, w, c) ->
    ((b h w), f, c) in x's dtype."""
    return _fold(_normalized(x, g, eps)).to(x.dtype)


def norm_untranspose_reference(out, res, g, eps):
    """Plain version of kernel 13 (`_norm_ut_kernel`): out ((b h w), f, c)
    normalised, unfolded to res's (b, f, h, w, c), plus res, in res's dtype."""
    return (_unfold(_normalized(out, g, eps), res.shape) + res.float()).to(res.dtype)


def _check(x, g, name):
    if not (x.is_cuda and g.device == x.device):
        raise ValueError(f'{name}: tensors must share one CUDA device')
    if x.dtype != torch.bfloat16:
        raise TypeError(f'{name} kernel takes bf16, got {x.dtype}')
    c = x.shape[-1]
    if not (c % 8 == 0 and c <= MAX_C) or tuple(g.shape) != (c,):
        raise ValueError(f'{name}: c {c} outside the kernel (c % 8 == 0, c <= {MAX_C}) '
                         f'or gain {tuple(g.shape)} != ({c},)')


def _ln_t_forward(x, g, eps):
    if x.device.type == 'cpu':
        return ln_transpose_reference(x, g, eps)
    if x.ndim != 5:
        raise ValueError(f'fused_ln_transpose takes (b, f, h, w, c), got {tuple(x.shape)}')
    _check(x, g, 'fused_ln_transpose')
    b, f, h, w, c = x.shape
    x = aligned_contiguous(x)
    gf = g.float().contiguous()
    y = torch.empty((b * h * w, f, c), dtype=x.dtype, device=x.device)
    _build.launch(LN_T_KERNEL, x.data_ptr(), gf.data_ptr(), y.data_ptr(), b, f, h * w, c,
                  float(eps))
    return y


def _norm_ut_forward(out, res, g, eps):
    if res.device.type == 'cpu':
        return norm_untranspose_reference(out, res, g, eps)
    if res.ndim != 5:
        raise ValueError(f'fused_norm_untranspose: res must be (b, f, h, w, c), '
                         f'got {tuple(res.shape)}')
    _check(res, g, 'fused_norm_untranspose')
    b, f, h, w, c = res.shape
    if tuple(out.shape) != (b * h * w, f, c) or out.dtype != res.dtype \
            or out.device != res.device:
        raise ValueError(f'fused_norm_untranspose: out {tuple(out.shape)} {out.dtype} does '
                         f'not fold res {tuple(res.shape)} {res.dtype}')
    out, res = aligned_contiguous(out), aligned_contiguous(res)
    gf = g.float().contiguous()
    y = torch.empty_like(res)
    _build.launch(NORM_UT_KERNEL, out.data_ptr(), res.data_ptr(), gf.data_ptr(), y.data_ptr(),
                  b, f, h * w, c, float(eps))
    return y


class _LnTranspose(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, eps):
        ctx.save_for_backward(x, g)
        ctx.eps = eps
        return _ln_t_forward(x, g, eps)

    @staticmethod
    def backward(ctx, gy):
        return (*recomputed_grads(ctx, lambda x, g: layernorm(_fold(x), g, ctx.eps), gy),
                None)


class _NormUntranspose(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, res, g, eps):
        ctx.save_for_backward(out, res, g)
        ctx.eps = eps
        return _norm_ut_forward(out, res, g, eps)

    @staticmethod
    def backward(ctx, gy):
        def chain(out, res, g):
            return _unfold(layernorm(out, g, ctx.eps), res.shape) + res
        return (*recomputed_grads(ctx, chain, gy), None)


def fused_ln_transpose(x, g, eps):
    """LayerNorm over c fused with (b f h w c) -> ((b h w) f c)."""
    if wants_grad(x, g):
        return _LnTranspose.apply(x, g, eps)
    return _ln_t_forward(x, g, eps)


def fused_norm_untranspose(out, res, g, eps):
    """Out-norm of ((b h w), f, c) fused with the unfold to (b, f, h, w, c)
    and the residual add of `res`."""
    if wants_grad(out, res, g):
        return _NormUntranspose.apply(out, res, g, eps)
    return _norm_ut_forward(out, res, g, eps)


def temporal_residual(x, g_in, attend, g_out, plain, fused=False):
    """A `models.video_blocks.TemporalAttention` call on x (b, f, h, w, c).
    Where `fused` and the gate admit x, kernel 12 normalises (gain `g_in`)
    and folds x to ((b h w), f, c) for `attend`, and kernel 13 normalises
    (gain `g_out`), unfolds and adds x; else `plain()`."""
    if not (fused and temporal_layout_available(x.shape, x.dtype, x.device.type)):
        return plain()
    out = attend(fused_ln_transpose(x, g_in, ln_eps(x.dtype)))
    return fused_norm_untranspose(out, x, g_out, ln_eps(out.dtype))
