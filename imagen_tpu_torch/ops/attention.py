"""Attention cores as plain functions; counterpart of `imagen_tpu/ops/attention.py`.

Cosine-sim attention (q/k l2-normalised, learned per-dim scales, fixed
scale 8), an fp32 softmax, a learned null KV token, and multi-query
attention (one KV head shared by all query heads). Each entry decides its
call's route and counts it once (`utils.profiling.count`):
`multiquery_attention` and `multiquery_attention_packed` send long
unmasked attention to the flash kernel (`ops/flash_attention.py`), counted
under `attention`, route `flash` or `plain`; `video_attention` also sends
the video U-Net's attention over each pixel's frames to the temporal
kernel, counted under `temporal_attention`. Every plain multi-query route
runs one core, `_plain_mqa`. The gates are read from `ops.flash_attention`,
so one patch there closes a gate for every caller.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from imagen_tpu_torch.ops import flash_attention as fa
from imagen_tpu_torch.ops.tensor_utils import l2norm
from imagen_tpu_torch.utils.helpers import exists
from imagen_tpu_torch.utils.profiling import count


def _masked_softmax_fp32(sim, mask=None, null_tokens: int = 0):
    """Softmax in fp32; `mask` (b, j_orig) is padded True for the `null_tokens`
    leading keys."""
    dtype = sim.dtype
    if exists(mask):
        if null_tokens > 0:
            mask = F.pad(mask, (null_tokens, 0), value=True)
        sim = sim.masked_fill(~mask[:, None, None, :], -torch.finfo(dtype).max)
    return torch.softmax(sim.float(), dim=-1).to(dtype)


def _count(route, b, heads, i, j, d, mask, attn_bias):
    """One attention call for the `attention` counter: QK^T and PV, 4 b h i j d."""
    count('attention', route, (b, heads, i, j, d, exists(mask), exists(attn_bias)),
          4 * b * heads * i * j * d)


def _plain_mqa(q, k, v, *, scale, mask=None, attn_bias=None, null_tokens=0, q_scale=None,
               k_scale=None, causal_mask=None):
    """The plain route: q (b, h, i, d); k, v (b, j, d); `causal_mask` (i, j)
    True where a key is hidden."""
    if exists(q_scale):
        q = l2norm(q) * q_scale.to(q.dtype)
        k = l2norm(k) * k_scale.to(k.dtype)
    sim = torch.einsum('bhid,bjd->bhij', q, k) * scale
    if exists(attn_bias):
        sim = sim + attn_bias
    if exists(causal_mask):
        sim = sim.masked_fill(causal_mask, -torch.finfo(sim.dtype).max)
    attn = _masked_softmax_fp32(sim, mask, null_tokens)
    return torch.einsum('bhij,bjd->bhid', attn, v)


def _plain_packed(q, k, v, heads, **kwargs):
    """`_plain_mqa` over head-packed q (b, n, h * d), back to (b, n, h * d)."""
    b, n, hd = q.shape
    q4 = q.reshape(b, n, heads, hd // heads).transpose(1, 2)
    return _plain_mqa(q4, k, v, **kwargs).transpose(1, 2).reshape(b, n, hd)


def _flash_packed(q, k, v, heads, scale, q_scale, k_scale):
    """The flash route over head-packed q (b, n, h * d): the layout reshapes
    for free to rows (b, n * h, d), so the head transposes never happen."""
    b, n, hd = q.shape
    rows = q.reshape(b, n * heads, hd // heads)
    if exists(q_scale):
        out = fa.flash_cosine_mqa_rows(rows, k, v, q_scale, k_scale, scale)
    else:
        out = fa.flash_mqa_rows(rows, k, v, scale)
    return out.reshape(b, n, hd)


def multiquery_attention(q, k, v, *, scale, mask=None, attn_bias=None, null_tokens=0,
                         q_scale=None, k_scale=None):
    """q (b, h, i, d); k, v (b, j, d). With q_scale/k_scale, q and k arrive raw
    and the cosine prologue is applied here (inside the kernel on the flash route)."""
    b, h, i, d = q.shape
    flash = fa.flash_attention_available(i, d, exists(mask), exists(attn_bias), dtype=q.dtype,
                                         device_type=q.device.type)
    _count('flash' if flash else 'plain', b, h, i, k.shape[-2], d, mask, attn_bias)
    if not flash:
        return _plain_mqa(q, k, v, scale=scale, mask=mask, attn_bias=attn_bias,
                          null_tokens=null_tokens, q_scale=q_scale, k_scale=k_scale)
    if exists(q_scale):
        return fa.flash_cosine_mqa(q, k, v, q_scale, k_scale, scale)
    return fa.flash_multiquery_attention(q, k, v, scale)


def multiquery_attention_packed(q, k, v, heads, *, scale, mask=None, attn_bias=None,
                                null_tokens=0, q_scale=None, k_scale=None):
    """multiquery_attention over head-packed queries: q (b, n, h * d) as the
    q projection emits it; k, v (b, j, d). Returns (b, n, h * d)."""
    b, n, hd = q.shape
    d = hd // heads
    flash = fa.flash_attention_available(n, d, exists(mask), exists(attn_bias), heads=heads,
                                         dtype=q.dtype, device_type=q.device.type)
    _count('flash' if flash else 'plain', b, heads, n, k.shape[-2], d, mask, attn_bias)
    if flash:
        return _flash_packed(q, k, v, heads, scale, q_scale, k_scale)
    return _plain_packed(q, k, v, heads, scale=scale, mask=mask, attn_bias=attn_bias,
                         null_tokens=null_tokens, q_scale=q_scale, k_scale=k_scale)


def video_attention(q, k, v, heads, *, scale, q_scale, k_scale, per_pixel=True, causal=False,
                    bias=None, mask=None, null_tokens=1):
    """`models.video_blocks.VideoAttention`'s attention: q (b, n, h * d) raw;
    k, v (b, nk, d), the null key (and context keys) first; `bias` (h, n, nk)
    fp32 or None; `per_pixel` without context and mask. As the JAX module:
    per-pixel calls without bias or causality take the flash rows kernel
    (`mid_attn`), other per-pixel calls the temporal kernel, each where its
    gate admits them; the rest `_plain_mqa`. The temporal kernel's calls and
    all others with a bias count under `temporal_attention`, keyed (pixels,
    frames, heads, nk, d); the rest under `attention`."""
    b, n, hd = q.shape
    d, nk = hd // heads, k.shape[-2]
    flash = (per_pixel and not causal and bias is None
             and fa.flash_attention_available(n, d, False, False, heads=heads, dtype=q.dtype,
                                              device_type=q.device.type))
    grouped = not flash and per_pixel and fa.grouped_temporal_available(
        n, heads, nk, d, q.dtype, q.device.type)
    causal_mask = (torch.ones((n, nk), dtype=torch.bool, device=q.device).triu(nk - n + 1)
                   if causal else None)
    if grouped or (not flash and exists(bias)):
        count('temporal_attention', 'kernel' if grouped else 'plain', (b, n, heads, nk, d),
              4 * b * heads * n * nk * d)
    else:
        _count('flash' if flash else 'plain', b, heads, n, nk, d, mask, bias)
    if flash:
        return _flash_packed(q, k, v, heads, scale, q_scale, k_scale)
    if grouped:
        table = bias if exists(bias) else torch.zeros((heads, n, nk), device=q.device)
        return fa.flash_grouped_cosine(q, k, v, q_scale, k_scale,
                                       fa.build_grouped_bias(table, causal_mask), scale, heads)
    return _plain_packed(q, k, v, heads, scale=scale, mask=mask, null_tokens=null_tokens,
                         attn_bias=bias[None].to(q.dtype) if exists(bias) else None,
                         q_scale=q_scale, k_scale=k_scale, causal_mask=causal_mask)


def multihead_attention(q, k, v, *, scale, mask=None, attn_bias=None, null_tokens=0):
    """Full multi-head attention: q, k, v are (b, h, n, d); always the plain route."""
    _count('plain', *q.shape[:3], k.shape[-2], q.shape[-1], mask, attn_bias)
    sim = torch.einsum('bhid,bhjd->bhij', q, k) * scale
    if exists(attn_bias):
        sim = sim + attn_bias
    attn = _masked_softmax_fp32(sim, mask, null_tokens)
    return torch.einsum('bhij,bhjd->bhid', attn, v)


def kernelized_linear_attention(q, k, v, *, scale):
    """softmax(q, -1) . softmax(k, -2) linear attention; q, k, v are
    (b*, n, d) with the heads folded into the batch. The JAX package
    computes it outside any Pallas kernel, so it stays plain here."""
    q = torch.softmax(q, dim=-1) * scale
    k = torch.softmax(k, dim=-2)
    context = torch.einsum('bnd,bne->bde', k, v)
    return torch.einsum('bnd,bde->bne', q, context)
