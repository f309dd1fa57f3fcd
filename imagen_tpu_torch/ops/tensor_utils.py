"""Tensor-level helper ops; counterpart of `imagen_tpu/ops/tensor_utils.py`.

Images are NHWC, as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from imagen_tpu_torch.utils.helpers import exists


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


def resize_image_to(image, target_image_size, clamp_range=None):
    """Nearest resize of an NHWC batch to a square size, then clamped to
    `clamp_range` (lo, hi) when given.

    'nearest-exact' samples at half-pixel centres, as `jax.image.resize` does.
    """
    if image.shape[-2] == target_image_size:
        return image
    out = F.interpolate(image.permute(0, 3, 1, 2), size=target_image_size,
                        mode='nearest-exact').permute(0, 2, 3, 1)
    if exists(clamp_range):
        out = out.clamp(*clamp_range)
    return out


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


def quantile_rows(flat, q):
    """Per-row `q`-quantile of a (b, n) tensor, with torch.quantile's linear
    interpolation between the two bracketing order statistics.

    `torch.kthvalue` picks the two order statistics; `torch.quantile` is
    avoided because it refuses inputs of more than 2**24 elements.
    """
    n = flat.shape[-1]
    pos = q * (n - 1)
    lo = int(pos // 1)
    frac = pos - lo
    if lo >= n - 1:
        return flat.amax(dim=-1)
    v_lo = torch.kthvalue(flat, lo + 1, dim=-1).values
    v_hi = torch.kthvalue(flat, lo + 2, dim=-1).values
    return v_lo + frac * (v_hi - v_lo)
