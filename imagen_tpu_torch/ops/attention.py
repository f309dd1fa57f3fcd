"""Attention cores as plain functions; counterpart of `imagen_tpu/ops/attention.py`.

Cosine-sim attention (q/k l2-normalised, learned per-dim scales, fixed
scale 8), an fp32 softmax, a learned null KV token, and multi-query
attention (one KV head shared by all query heads). Long unmasked
multi-query attention goes to the flash kernel (`ops/flash_attention.py`)
at the rows-reshape dispatch point of `multiquery_attention_packed`.
Each call is counted once under `attention` (`utils.profiling.count`),
route `flash` or `plain`, at the function that decides its route.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from imagen_tpu_torch.ops.flash_attention import (
    flash_attention_available,
    flash_cosine_mqa,
    flash_cosine_mqa_rows,
    flash_mqa_rows,
    flash_multiquery_attention,
)
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


def multiquery_attention(q, k, v, *, scale, mask=None, attn_bias=None, null_tokens=0,
                         q_scale=None, k_scale=None):
    """q (b, h, i, d); k, v (b, j, d). With q_scale/k_scale, q and k arrive raw
    and the cosine prologue is applied here (inside the kernel on the flash route)."""
    flash = flash_attention_available(q.shape[-2], q.shape[-1], exists(mask),
                                      exists(attn_bias), dtype=q.dtype,
                                      device_type=q.device.type)
    _count('flash' if flash else 'plain', *q.shape[:3], k.shape[-2], q.shape[-1], mask,
           attn_bias)
    return _multiquery_attention(q, k, v, flash, scale=scale, mask=mask, attn_bias=attn_bias,
                                 null_tokens=null_tokens, q_scale=q_scale, k_scale=k_scale)


def _multiquery_attention(q, k, v, flash, *, scale, mask, attn_bias, null_tokens, q_scale,
                          k_scale):
    cosine = exists(q_scale)
    if flash:
        if cosine:
            return flash_cosine_mqa(q, k, v, q_scale, k_scale, scale)
        return flash_multiquery_attention(q, k, v, scale)

    if cosine:
        q = l2norm(q) * q_scale.to(q.dtype)
        k = l2norm(k) * k_scale.to(k.dtype)

    sim = torch.einsum('bhid,bjd->bhij', q, k) * scale
    if exists(attn_bias):
        sim = sim + attn_bias
    attn = _masked_softmax_fp32(sim, mask, null_tokens)
    return torch.einsum('bhij,bjd->bhid', attn, v)


def multiquery_attention_packed(q, k, v, heads, *, scale, mask=None, attn_bias=None,
                                null_tokens=0, q_scale=None, k_scale=None):
    """multiquery_attention over head-packed queries: q (b, n, h * d) as the
    q projection emits it; k, v (b, j, d). Returns (b, n, h * d).

    On the flash route the packed layout reshapes for free to rows
    (b, n * h, d), so the head transposes never happen."""
    b, n, hd = q.shape
    d = hd // heads
    flash = flash_attention_available(n, d, exists(mask), exists(attn_bias), heads=heads,
                                      dtype=q.dtype, device_type=q.device.type)
    _count('flash' if flash else 'plain', b, heads, n, k.shape[-2], d, mask, attn_bias)
    if flash:
        q_rows = q.reshape(b, n * heads, d)
        if exists(q_scale):
            out = flash_cosine_mqa_rows(q_rows, k, v, q_scale, k_scale, scale)
        else:
            out = flash_mqa_rows(q_rows, k, v, scale)
        return out.reshape(b, n, hd)

    # the plain route: where the rows gate refuses, so does the (b, h, n, d) one (a block
    # that divides n divides n * heads)
    q4 = q.reshape(b, n, heads, d).transpose(1, 2)
    out = _multiquery_attention(q4, k, v, False, scale=scale, mask=mask, attn_bias=attn_bias,
                                null_tokens=null_tokens, q_scale=q_scale, k_scale=k_scale)
    return out.transpose(1, 2).reshape(b, n, hd)


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
