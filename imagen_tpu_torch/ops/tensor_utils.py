"""Tensor-level helper ops; counterpart of `imagen_tpu/ops/tensor_utils.py`.

Images are NHWC, as in the JAX package.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from imagen_tpu_torch.ops import _build
from imagen_tpu_torch.utils.helpers import exists
from imagen_tpu_torch.utils.profiling import count


def wants_grad(*tensors):
    """Whether autograd would record a call on these tensors (None skipped):
    the kernel wrappers take their autograd Function only then."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def aligned_contiguous(t):
    """Contiguous, and on a 16-byte boundary for the CUDA kernels' vector loads."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def log(t, eps: float = 1e-12):
    """Stable log."""
    return torch.log(t.clamp(min=eps))


def l2norm(t, dim: int = -1, eps: float = 1e-12):
    """F.normalize equivalent: t / max(||t||, eps)."""
    return t / torch.linalg.vector_norm(t, dim=dim, keepdim=True).clamp(min=eps)


def right_pad_dims_to(x, t):
    """Right-pad `t`'s shape with singleton dims to match x.ndim."""
    padding_dims = x.ndim - t.ndim
    if padding_dims <= 0:
        return t
    return t.reshape(*t.shape, *((1,) * padding_dims))


def masked_mean(t, *, dim, mask=None):
    """Mean over `dim`, ignoring positions where mask is False. t (b, n, d), mask (b, n)."""
    if not exists(mask):
        return t.mean(dim=dim)
    denom = mask.sum(dim=dim, keepdim=True)
    masked_t = t.masked_fill(~mask[..., None], 0.)
    return masked_t.sum(dim=dim) / denom.clamp(min=1e-5)


def resize_image_to(image, target_image_size, clamp_range=None, method='nearest'):
    """Resize of an NHWC batch to a square size with a `jax.image.resize`
    method (`resize_axes`), then clamped to `clamp_range` (lo, hi) when given.

    Nearest is 'nearest-exact', which samples at half-pixel centres, as
    `jax.image.resize` does.
    """
    if image.shape[-2] == target_image_size:
        return image
    if resize_kernel(method) is None:
        out = F.interpolate(image.permute(0, 3, 1, 2), size=target_image_size,
                            mode='nearest-exact').permute(0, 2, 3, 1)
    else:
        out = resize_axes(image, {1: target_image_size, 2: target_image_size}, method)
    if exists(clamp_range):
        out = out.clamp(*clamp_range)
    return out


# --- jax.image.resize's scale-and-translate ------------------------------------------------

def _triangle(x):
    return np.maximum(x.dtype.type(0.), 1 - np.abs(x))


def _keys_cubic(x):
    """Keys' cubic convolution kernel with a = -0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.
    out = np.where(x >= 1., ((-0.5 * x + 2.5) * x - 4.) * x + 2., out)
    return np.where(x >= 2., 0., out)


def _lanczos(radius):
    def kernel(x):
        y = radius * np.sin(np.pi * x) * np.sin(np.pi * x / radius)
        with np.errstate(divide='ignore', invalid='ignore'):
            out = np.where(x > 1e-3, y / np.where(x != 0, np.pi ** 2 * x ** 2, 1.), 1.)
        return np.where(x > radius, 0., out)
    return kernel


_RESIZE_KERNELS = {
    'nearest': None,
    **dict.fromkeys(('linear', 'bilinear', 'trilinear', 'triangle'), _triangle),
    **dict.fromkeys(('cubic', 'bicubic', 'tricubic'), _keys_cubic),
    'lanczos3': _lanczos(3.),
    'lanczos5': _lanczos(5.),
}


def resize_kernel(method):
    """The interpolation kernel of a `jax.image.resize` method name (None
    for nearest); raises on an unknown name."""
    if method not in _RESIZE_KERNELS:
        raise ValueError(f'unknown resize method {method!r}; expected one of '
                         f'{sorted(_RESIZE_KERNELS)}')
    return _RESIZE_KERNELS[method]


@functools.lru_cache(maxsize=256)
def _resize_matrix(in_size, out_size, method):
    """`jax.image.resize`'s (in, out) weight matrix for one axis: the kernel
    sampled at half-pixel centres, widened by the scale factor when the
    axis shrinks (the antialias), each column normalised to sum 1, and zero
    where the sample falls outside the input. In float32 arithmetic, step
    for step as JAX makes it, whose float32 rounding of the weights shows
    at 1e-5 in the result."""
    f32 = np.float32
    kernel = resize_kernel(method)
    inv_scale = f32(1. / (out_size / in_size))
    kernel_scale = np.maximum(inv_scale, f32(1.))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = kernel(x).astype(f32)
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > f32(1000. * np.finfo(f32).eps),
                       weights / np.where(total != 0, total, f32(1.)), f32(0.))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.from_numpy(np.where(inside[None, :], weights, f32(0.)).astype(f32))


@functools.lru_cache(maxsize=256)
def _resize_matrix_on(in_size, out_size, method, device, dtype):
    """`_resize_matrix` in `dtype` on `device`, kept: a forward that resizes
    its cond images then copies no matrix to the card."""
    return _resize_matrix(in_size, out_size, method).to(device, dtype)


def resize_axes(x, sizes, method):
    """`x` resized along each axis of `sizes` ({axis: size}) with a
    `jax.image.resize` method other than nearest: one (in, out) weight
    matrix per axis that changes size (`_resize_matrix`), applied one axis
    at a time in fp32 (float64 for a float64 input); the result in x's
    dtype. One path for images and for video in time and space."""
    dtype = x.dtype
    compute = torch.promote_types(dtype, torch.float32)
    out = x.to(compute)
    for axis, size in sorted(sizes.items()):
        if out.shape[axis] == size:
            continue
        w = _resize_matrix_on(out.shape[axis], size, method, out.device, compute)
        out = torch.movedim(torch.movedim(out, axis, -1) @ w, -1, axis)
    return out.to(dtype)


def cast_uint8_images_to_float(images):
    """uint8 [0, 255] -> float [0, 1]; other dtypes pass through."""
    if images.dtype != torch.uint8:
        return images
    return images.float() / 255


def normalize_neg_one_to_one(img):
    return img * 2 - 1


def unnormalize_zero_to_one(normed_img):
    return (normed_img + 1) * 0.5


def prob_mask_like(shape, prob, device, generator=None):
    """Bernoulli keep-mask for classifier-free-guidance dropout, drawn from
    `generator` (torch's global generator when None)."""
    if prob == 1:
        return torch.ones(shape, dtype=torch.bool, device=device)
    if prob == 0:
        return torch.zeros(shape, dtype=torch.bool, device=device)
    return torch.rand(shape, device=device, generator=generator) < prob


# `nonneg_order_stats`'s CUDA kernel (`csrc/order_stats.cu`): its C entry, the
# scratch words it keeps a row, and its threads a block.
ORDER_STATS_KERNEL = 'nonneg_order_stats'
ORDER_STATS_WORDS = 4102
ORDER_STATS_THREADS = 512


def order_stats_blocks(b, n, sms):
    """Blocks a row of the order-statistics kernel's grid: about 16
    elements a thread, and at most 4 blocks an SM over the b rows. A row of
    12,288 gets 2 blocks, one of 3 x 1024^2 384 (the whole card)."""
    return max(1, min(-(-n // (16 * ORDER_STATS_THREADS)), 4 * sms // b))


def nonneg_order_stats(flat, lo):
    """Exact ascending order statistics (x_(lo), x_(lo+1)) of each row of
    |flat|, a (b, n) tensor, as two fp32 (b,) tensors; 0 <= lo < n - 1.

    On a non-negative fp32 tensor this is the JAX function's contract; a
    signed one gives the statistics of its magnitudes (-0.0 counts as 0.0),
    and any float dtype is widened to fp32, so the results are
    `torch.kthvalue`'s over `flat.abs().float()`, bit for bit. A CUDA
    tensor takes the radix-select kernel, which reads fp32 and bf16 as they
    are (other dtypes are cast to fp32 first); other devices take
    `kthvalue`. Each call is counted under `threshold`, route `kernel` or
    `kthvalue`, with its b * n elements as its work.
    """
    b, n = flat.shape
    if not 0 <= lo < n - 1:
        raise ValueError(f'nonneg_order_stats: lo {lo} outside [0, {n - 1}) for rows of {n}')
    if flat.device.type == 'cuda':
        count('threshold', 'kernel', (b, n), b * n)
        return _order_stats_kernel(flat, lo)
    count('threshold', 'kthvalue', (b, n), b * n)
    return order_stats_reference(flat, lo)


def order_stats_reference(flat, lo):
    """`nonneg_order_stats` in plain PyTorch: two `torch.kthvalue`s over
    |flat| in fp32."""
    mags = flat.abs().float()
    return (torch.kthvalue(mags, lo + 1, dim=-1).values,
            torch.kthvalue(mags, lo + 2, dim=-1).values)


def _order_stats_kernel(flat, lo):
    if flat.dtype not in (torch.float32, torch.bfloat16):
        flat = flat.float()
    flat = flat.contiguous()
    b, n = flat.shape
    scratch = torch.zeros((b, ORDER_STATS_WORDS), dtype=torch.int32, device=flat.device)
    out = torch.empty((b, 2), dtype=torch.float32, device=flat.device)
    _build.launch(ORDER_STATS_KERNEL, flat.data_ptr(), scratch.data_ptr(), out.data_ptr(), b, n,
                  lo, int(flat.dtype == torch.bfloat16),
                  order_stats_blocks(b, n, _build.sm_count(flat.device.index)),
                  ORDER_STATS_WORDS)
    return out[:, 0], out[:, 1]


def quantile_position(n, q):
    """(lo, frac): the `q`-quantile of n ascending values x_(0..n-1) is
    x_(lo) + frac (x_(lo+1) - x_(lo)), torch.quantile's linear interpolation."""
    pos = q * (n - 1)
    lo = int(pos // 1)
    return lo, pos - lo


def quantile_rows(flat, q):
    """Per-row `q`-quantile of the magnitudes |flat| of a (b, n) tensor, in
    fp32, with torch.quantile's linear interpolation between the two
    bracketing order statistics (`nonneg_order_stats`).

    `torch.quantile` is avoided because it sorts, and refuses inputs of more
    than 2**24 elements.
    """
    n = flat.shape[-1]
    lo, frac = quantile_position(n, q)
    if lo >= n - 1:
        return flat.abs().float().amax(dim=-1)
    v_lo, v_hi = nonneg_order_stats(flat, lo)
    return v_lo + frac * (v_hi - v_lo)
