"""Flash multi-query attention over rows, forward and backward (kernels 1-3
of the port), and per-pixel temporal attention (kernel 4).

Counterpart of `imagen_tpu/ops/flash_attention.py` (`flash_cosine_mqa_rows`,
`flash_mqa_rows` -> `_flash_rows_forward`, and their custom VJP over
`_flash_rows_backward_impl`). The CUDA kernels are `csrc/flash_rows_fwd.cu`
and `csrc/flash_rows_bwd.cu`; their headers say what bounds them on the H100
and how their designs answer that.

Rows layout: multi-query attention (one shared K/V head) is single-head
attention over R = n * h independent query rows, so the module's packed
(b, n, h * d) queries reshape for free to rows (b, R, d).

    q: (b, R, d)   k, v: (b, nk, d)   ->   out: (b, R, d)

The entry points are autograd Functions when a gradient is wanted: the
forward then also keeps each row's log2-sum-exp2 (`lse`), and the backward
runs the backward kernel on `delta = rowsum(dO * O)`. On the cosine path the
backward recomputes the normalised q and k and chains the l2norm + gain VJP
outside the kernel, as `_cos_rows_bwd` does. Under `torch.no_grad()` the
forward computes no `lse` and saves nothing.

The grouped section at the end is the video counterpart: per-pixel causal
temporal attention (`flash_grouped_cosine`, kernel `csrc/temporal_attn_fwd.cu`).

On a CPU tensor the kernels' plain PyTorch versions run
(`flash_rows_reference`, `flash_rows_backward_reference`,
`temporal_attention_reference`); on a CUDA tensor the kernels launch or
raise.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from imagen_tpu_torch.ops import _build
from imagen_tpu_torch.ops.fused_norm import recomputed_grads
from imagen_tpu_torch.ops.tensor_utils import wants_grad

FLASH_MIN_SEQ = 1024
LOG2E = math.log2(math.e)
KERNEL = 'flash_rows_fwd_bf16'
BWD_KERNEL = 'flash_rows_bwd_bf16'
_KERNEL_DIMS = (16, 32, 64, 128)   # head dims the kernels take; others pad up
BWD_KEYS = 128    # keys per dK/dV block of the backward kernel
BWD_ROWS = 64     # q rows per streamed tile of its dK/dV pass


def _pick_block_q(rows):
    for bq in (512, 256, 128):
        if rows % bq == 0:
            return bq
    return None


def flash_attention_available(q_len, dim_head, has_mask, has_bias, heads=1,
                              dtype=torch.bfloat16, device_type='cuda'):
    """The shape gate of `flash_attention_available` in the JAX package.

    The CUDA kernel takes bf16 only, so a CUDA tensor of another dtype stays
    on the plain attention path; on the CPU the wrapper runs the plain version.
    """
    if has_mask or has_bias:
        return False
    if q_len < FLASH_MIN_SEQ or dim_head > 128:
        return False
    if _pick_block_q(q_len * heads) is None:
        return False
    return device_type == 'cpu' or dtype == torch.bfloat16


def l2norm_scale(t, gain):
    """Row l2norm times a learned per-dim gain, in fp32, rounded to t's dtype."""
    tf = t.float()
    inv = torch.rsqrt((tf * tf).sum(dim=-1, keepdim=True).clamp(min=1e-12))
    return (tf * inv * gain.float()).to(t.dtype)


def flash_rows_reference(q, k, v, scale, q_scale=None, return_lse=False):
    """Plain PyTorch version of the forward kernel: the q prologue, an exp2
    softmax with fp32 statistics and P rounded to v's dtype before P @ V.
    With `return_lse`, also the row log2-sum-exp2 in the scaled base-2 domain.

    `k` is already normalised on the cosine path (see `flash_cosine_mqa_rows`).
    """
    s2 = scale * LOG2E
    if q_scale is not None:
        qp = l2norm_scale(q, q_scale.float() * s2)
    else:
        qp = (q.float() * s2).to(q.dtype)
    s = torch.matmul(qp.float(), k.float().transpose(-1, -2))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    out = (acc / l).to(q.dtype)
    return (out, (m + torch.log2(l))[..., 0]) if return_lse else out


def flash_rows_backward_reference(q, k, v, do, lse, delta, scale):
    """Plain PyTorch version of the backward kernel, with the arithmetic of
    the Pallas kernels: q unscaled, scale * log2(e) applied to the fp32
    scores, P rounded before P^T dO and dS before dS k and dS^T q."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (scale * LOG2E)
    p = torch.exp2(s - lse[..., None])
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.matmul(ds.to(k.dtype).float(), k.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _pad_d(d):
    return next(x for x in _KERNEL_DIMS if x >= d)


def bwd_splits(b, rows, nk, sm_count, min_tiles=4):
    """How many slices S of the R rows the backward's dK/dV pass splits
    across blocks: its grid is b * ceil(nk / BWD_KEYS) * S blocks. S is 1
    where that grid already fills the SMs twice, else the least S that does,
    but never below `min_tiles` row tiles of BWD_ROWS a slice (each block
    loads its K and V tiles once, whatever its slice's length)."""
    blocks = b * -(-nk // BWD_KEYS)
    if blocks >= 2 * sm_count:
        return 1
    tiles = -(-rows // BWD_ROWS)
    return max(1, min(-(-2 * sm_count // blocks), tiles // min_tiles))


def split_row_ranges(rows, splits):
    """The (start, end) q rows of each of the S slices of the dK/dV pass: a
    balanced split of the row tiles, as the kernel computes it."""
    tiles = -(-rows // BWD_ROWS)
    bounds = [tiles * s // splits * BWD_ROWS for s in range(splits + 1)]
    return [(lo, min(hi, rows)) for lo, hi in zip(bounds, bounds[1:])]


def _check_rows(q, k, v, name):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f'{name}: tensors must share one CUDA device')
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f'{name} kernel takes bf16, got {q.dtype}, {k.dtype}, {v.dtype}')
    b, rows, d = q.shape
    nk = k.shape[1]
    if k.shape != (b, nk, d) or v.shape != (b, nk, d):
        raise ValueError(f'shape mismatch q {q.shape} k {k.shape} v {v.shape}')
    if d > 128:
        raise ValueError(f'head dim {d} > 128')
    return b, rows, nk, d


def _padded(tensors, d):
    """Zero columns change no dot product and no norm; sliced off after. The
    kernels read 16-byte vectors and TMA tiles, so each tensor is also
    contiguous and 16-byte aligned."""
    dp = _pad_d(d)
    return [_aligned(F.pad(t, (0, dp - d)) if dp != d else t) for t in tensors], dp


def _aligned(t):
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _rows_forward(q, k, v, scale, q_scale, with_lse=False):
    """(out, lse or None); `k` already normalised on the cosine path."""
    if q.device.type == 'cpu':
        if with_lse:
            return flash_rows_reference(q, k, v, scale, q_scale, return_lse=True)
        return flash_rows_reference(q, k, v, scale, q_scale), None
    b, rows, nk, d = _check_rows(q, k, v, 'flash rows attention')
    (q, k, v), dp = _padded((q, k, v), d)
    qs = None
    if q_scale is not None:
        qs = F.pad(q_scale.float(), (0, dp - d)).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, rows), dtype=torch.float32, device=q.device) if with_lse else None
    _build.launch(KERNEL, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  None if qs is None else qs.data_ptr(), out.data_ptr(),
                  None if lse is None else lse.data_ptr(), b, rows, nk, dp, scale * LOG2E)
    return (out[..., :d] if dp != d else out), lse


def flash_rows_backward(q, k, v, do, lse, delta, scale):
    """(dq, dk, dv) of flash rows attention over pre-normalised q, k: the
    function of `_flash_rows_backward_impl`. `lse` is the forward's row
    log2-sum-exp2 and `delta` = rowsum(dO * O), both (b, R) fp32."""
    if q.device.type == 'cpu':
        return flash_rows_backward_reference(q, k, v, do, lse, delta, scale)
    b, rows, nk, d = _check_rows(q, k, v, 'flash rows backward')
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f'dout {tuple(do.shape)} {do.dtype} does not match q')
    if lse.shape != (b, rows) or delta.shape != (b, rows):
        raise ValueError(f'lse {tuple(lse.shape)}, delta {tuple(delta.shape)} != {(b, rows)}')
    (q, k, v, do), dp = _padded((q, k, v, do), d)
    lse, delta = _aligned(lse.float()), _aligned(delta.float())
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    splits = bwd_splits(b, rows, nk, _build.sm_count(q.device.index))
    # the fp32 dK and dV partials of each slice of R, summed by the kernel's second pass
    part = torch.empty((2, splits, b, nk, dp), dtype=torch.float32, device=q.device)
    _build.launch(BWD_KERNEL, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), part.data_ptr(), b, rows, nk, dp, splits, scale)
    if dp != d:
        dq, dk, dv = dq[..., :d], dk[..., :d], dv[..., :d]
    return dq, dk, dv


def _delta(do, o):
    """rowsum(dO * O) in fp32, as `_delta` of the JAX package."""
    return (do.float() * o.float()).sum(dim=-1)


class _FlashRows(torch.autograd.Function):
    """Flash rows attention with the flash backward; on the cosine path
    (q_scale and k_scale given) q and k arrive raw."""

    @staticmethod
    def forward(ctx, q, k, v, q_scale, k_scale, scale):
        cosine = q_scale is not None
        kn = l2norm_scale(k, k_scale) if cosine else k
        out, lse = _rows_forward(q, kn, v, scale, q_scale, with_lse=True)
        ctx.save_for_backward(q, k, v, q_scale, k_scale, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, q_scale, k_scale, out, lse = ctx.saved_tensors
        g = g.contiguous()
        delta = _delta(g, out)
        if q_scale is None:
            dq, dk, dv = flash_rows_backward(q, k, v, g, lse, delta, ctx.scale)
            return dq, dk, dv, None, None, None
        # recompute the normalised q and k, run the backward at that
        # boundary, then chain the l2norm + gain VJP (`_cos_rows_bwd`)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, q_scale, k, k_scale)]
            qn = l2norm_scale(leaves[0], leaves[1])
            kn = l2norm_scale(leaves[2], leaves[3])
        dqn, dkn, dv = flash_rows_backward(qn.detach(), kn.detach(), v, g, lse, delta,
                                           ctx.scale)
        dq, dqs, dk, dks = torch.autograd.grad((qn, kn), leaves, (dqn, dkn))
        return dq, dk, dv, dqs, dks, None


def flash_cosine_mqa_rows(q, k, v, q_scale, k_scale, scale):
    """Cosine-sim flash rows attention: raw q/k plus learned per-dim gains.

    k is normalised here, once, as the JAX package does outside its kernel;
    the q normalisation runs inside the kernel."""
    if wants_grad(q, k, v, q_scale, k_scale):
        return _FlashRows.apply(q, k, v, q_scale, k_scale, scale)
    return _rows_forward(q, l2norm_scale(k, k_scale), v, scale, q_scale)[0]


def flash_mqa_rows(q, k, v, scale):
    """Flash rows attention over pre-normalised q/k."""
    if wants_grad(q, k, v):
        return _FlashRows.apply(q, k, v, None, None, scale)
    return _rows_forward(q, k, v, scale, None)[0]


def flash_cosine_mqa(q, k, v, q_scale, k_scale, scale):
    """(b, h, n, d) layout of `flash_cosine_mqa_rows`."""
    b, h, n, d = q.shape
    out = flash_cosine_mqa_rows(q.reshape(b, h * n, d), k, v, q_scale, k_scale, scale)
    return out.reshape(b, h, n, d)


def flash_multiquery_attention(q, k, v, scale):
    b, h, n, d = q.shape
    return flash_mqa_rows(q.reshape(b, h * n, d), k, v, scale).reshape(b, h, n, d)


# --- grouped temporal attention (video) ---------------------------------------------------
#
# Counterpart of the grouped section of the JAX package (`flash_grouped_cosine`,
# `_grouped_packed_forward`) and of its rows-packed variant
# (`flash_temporal_rows`): per-pixel causal multi-query attention over frames,
# with one learned bias table shared by every pixel. The TPU kernels pack G
# pixels into one block-diagonal tile; here the layout is per pixel:
#
#     q: (P, f, h * d)   k, v: (P, nk, d), null key first   bias: (h, f, nk)
#
# with P = b * H * W pixels and nk = f + 1. `bias` is fp32 in the natural
# domain with -1e30 where masked (`build_grouped_bias`). One kernel serves
# both TPU kernels: a block-diagonal tile of either converts to this table.

TEMPORAL_KERNEL = 'temporal_attn_fwd_bf16'
TEMPORAL_MAX_NK = 64      # keys per pixel the kernel holds
TEMPORAL_MAX_ROWS = 128   # frames * heads per pixel (8 warps of 16 rows)
NEG_INF = -1e30


def grouped_temporal_available(frames, heads, nk, dim_head, dtype=torch.bfloat16,
                               device_type='cuda'):
    """Whether per-pixel temporal attention takes the kernel route.

    Departs from `grouped_temporal_available` of the JAX package, whose
    conditions pick a pixel group size G for the TPU's VMEM (G divides the
    batch, the block-diagonal bias tile fits, rows % 8): the kernel works per
    pixel, so none of those apply. What stays: the caller routes only
    per-pixel attention here (no context, no mask), as the JAX module does.
    What is added: the kernel's limits (nk <= 64, dim_head <= 128,
    frames * heads <= 128) and, on CUDA, bf16. The answer is a bool, not G.
    """
    return (nk <= TEMPORAL_MAX_NK and dim_head <= _KERNEL_DIMS[-1]
            and frames * heads <= TEMPORAL_MAX_ROWS
            and (device_type == 'cpu' or dtype == torch.bfloat16))


def build_grouped_bias(bias_hfj, causal_mask=None):
    """The per-pixel bias table of `flash_grouped_cosine`: `bias_hfj` (h, f,
    nk) in the natural domain with -1e30 where `causal_mask` (f, nk; True =
    masked) is set, fp32. `build_grouped_bias` of the JAX package at G = 1."""
    blk = bias_hfj.float()
    if causal_mask is not None:
        blk = blk.masked_fill(causal_mask[None], NEG_INF)
    return blk


def temporal_attention_reference(q, kn, v, q_scale, bias, scale, heads):
    """Plain PyTorch version of the temporal kernel, with the arithmetic of
    `_grouped_packed_kernel`: the cosine q prologue times scale * log2(e),
    rounded to q's dtype; fp32 scores plus bias * log2(e); an exp2 softmax
    with fp32 statistics; P rounded to v's dtype before P @ V. `kn` is the
    already normalised k."""
    P, f, hd = q.shape
    d = hd // heads
    nk = kn.shape[1]
    qn = l2norm_scale(q.reshape(P, f * heads, d), q_scale.float() * (scale * LOG2E))
    s = torch.matmul(qn.float(), kn.float().transpose(-1, -2))
    bias2 = (bias.float() * LOG2E).transpose(0, 1).reshape(f * heads, nk)
    s = s + bias2
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / l).to(q.dtype).reshape(P, f, hd)


def _temporal_forward(q, kn, v, q_scale, bias, scale, heads):
    if q.device.type == 'cpu':
        return temporal_attention_reference(q, kn, v, q_scale, bias, scale, heads)
    if not (q.is_cuda and kn.device == q.device and v.device == q.device):
        raise ValueError('flash_grouped_cosine: tensors must share one CUDA device')
    if not (q.dtype == kn.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f'temporal kernel takes bf16, got {q.dtype}, {kn.dtype}, {v.dtype}')
    if not (q.is_contiguous() and kn.is_contiguous() and v.is_contiguous()):
        raise ValueError('flash_grouped_cosine: q, k and v must be contiguous')
    P, f, hd = q.shape
    d, nk = hd // heads, kn.shape[1]
    if hd != heads * d or kn.shape != (P, nk, d) or v.shape != (P, nk, d):
        raise ValueError(f'shape mismatch q {tuple(q.shape)} k {tuple(kn.shape)} '
                         f'v {tuple(v.shape)} heads {heads}')
    if tuple(bias.shape) != (heads, f, nk) or tuple(q_scale.shape) != (d,):
        raise ValueError(f'bias {tuple(bias.shape)} != {(heads, f, nk)} or q_scale '
                         f'{tuple(q_scale.shape)} != {(d,)}')
    if not grouped_temporal_available(f, heads, nk, d, q.dtype, 'cuda'):
        raise ValueError(f'temporal kernel: frames {f} x heads {heads}, nk {nk}, d {d} '
                         'outside its limits')
    q_rows = q.reshape(P, f * heads, d)
    dp = _pad_d(d)
    if dp != d:  # zero columns change no dot product and no norm; sliced off after
        q_rows, kn, v = (F.pad(t, (0, dp - d)).contiguous() for t in (q_rows, kn, v))
    qs = q_scale.float()
    qs = (F.pad(qs, (0, dp - d)) if dp != d else qs).contiguous()
    bias2 = (bias.float() * LOG2E).contiguous()
    out = torch.empty_like(q_rows)
    _build.launch(TEMPORAL_KERNEL, q_rows.data_ptr(), kn.data_ptr(), v.data_ptr(),
                  qs.data_ptr(), bias2.data_ptr(), out.data_ptr(), P, f, heads, nk, dp,
                  scale * LOG2E)
    if dp != d:
        out = out[..., :d]
    return out.reshape(P, f, hd)


class _GroupedTemporal(torch.autograd.Function):
    """The temporal kernel forward; the backward differentiates the plain
    version, recomputed (an XLA recompute in the JAX package, `_grouped_bwd`)."""

    @staticmethod
    def forward(ctx, q, k, v, q_scale, k_scale, bias, scale, heads):
        ctx.save_for_backward(q, k, v, q_scale, k_scale, bias)
        ctx.scale, ctx.heads = scale, heads
        return _temporal_forward(q, l2norm_scale(k, k_scale), v, q_scale, bias, scale, heads)

    @staticmethod
    def backward(ctx, g):
        def chain(q, k, v, q_scale, k_scale, bias):
            return temporal_attention_reference(q, l2norm_scale(k, k_scale), v, q_scale, bias,
                                                ctx.scale, ctx.heads)
        return (*recomputed_grads(ctx, chain, g), None, None)


def flash_grouped_cosine(q, k, v, q_scale, k_scale, bias, scale, heads):
    """Per-pixel cosine-sim temporal attention: q (P, f, h * d) packed, raw k
    and v (P, nk, d), learned gains q_scale, k_scale (d,), bias (h, f, nk)
    from `build_grouped_bias`. k is normalised here, once; the q
    normalisation runs inside the kernel. Returns (P, f, h * d)."""
    if wants_grad(q, k, v, q_scale, k_scale, bias):
        return _GroupedTemporal.apply(q, k, v, q_scale, k_scale, bias, scale, heads)
    return _temporal_forward(q, l2norm_scale(k, k_scale), v, q_scale, bias, scale, heads)
