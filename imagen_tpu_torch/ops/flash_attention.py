"""Flash multi-query attention over rows, forward and backward: kernels 1-3
of the port.

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

On a CPU tensor the kernels' plain PyTorch versions run
(`flash_rows_reference`, `flash_rows_backward_reference`); on a CUDA tensor
the kernels launch or raise.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from imagen_tpu_torch.ops import _build
from imagen_tpu_torch.ops.tensor_utils import wants_grad

FLASH_MIN_SEQ = 1024
LOG2E = math.log2(math.e)
KERNEL = 'flash_rows_fwd_bf16'
BWD_KERNEL = 'flash_rows_bwd_bf16'


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
    return -(-d // 16) * 16


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
    """Zero columns change no dot product and no norm; sliced off after."""
    dp = _pad_d(d)
    return [(F.pad(t, (0, dp - d)) if dp != d else t).contiguous() for t in tensors], dp


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
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _build.launch(BWD_KERNEL, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), b, rows, nk, dp, scale)
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
