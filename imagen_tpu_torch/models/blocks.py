"""Neural building blocks (torch.nn, NHWC activations); counterpart of
`imagen_tpu/models/blocks.py`, for the blocks the 64->256 cascade uses.

- Activations are NHWC, as in the JAX package, so each module reads line by
  line against its flax counterpart: a 1x1 conv is a Linear on the trailing
  axis and ChanLayerNorm is LayerNorm.
- Parameters keep lucidrains' `state_dict` key names and torch shapes
  (positional Sequentials, Linear (O, I), Conv (O, I, kh, kw), ChanRMSNorm
  gamma (C, 1, 1)), so `utils/port_weights.py` only inverts the JAX package's
  table.
- Dtype follows flax: parameters stay fp32 and are cast to the module's
  compute `dtype` where they are used; `TorchLayerNorm` takes its statistics
  in fp32.
- PixelShuffleUpsample, Downsample and CrossEmbedLayer compute in their plain
  forms (1x1 conv + pixel shuffle, space-to-depth + Linear, per-scale convs +
  concat, or kernel 14 for a stem its gate admits); the JAX package's
  transposed-conv, strided-conv and phase-tiled forms were TPU layout
  workarounds.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from imagen_tpu_torch.ops.attention import multihead_attention, multiquery_attention_packed
from imagen_tpu_torch.ops.conv2d import conv2d_same, conv2d_same_available
from imagen_tpu_torch.ops.fused_norm import (
    fused_feedforward,
    fused_feedforward_available,
    fused_film_available,
    fused_film_norm,
    layernorm,
    pack_ff_weights,
)
from imagen_tpu_torch.ops.stem_conv import cross_embed_stem, pack_stem_weights, stem_available
from imagen_tpu_torch.ops.temporal_layout import fused_ln_transpose
from imagen_tpu_torch.ops.tensor_utils import l2norm, masked_mean, resize_image_to, wants_grad
from imagen_tpu_torch.utils.helpers import cast_tuple, default, exists

F32 = torch.float32


def ln_eps(dtype):
    return 1e-5 if dtype == F32 else 1e-3


# --- layers that cast their fp32 parameters at use ----------------------------------------

class Linear(nn.Linear):
    """nn.Linear computing in `dtype` (flax `Dense(dtype=...)`)."""

    def __init__(self, dim_in, dim_out, bias=True, dtype=F32):
        super().__init__(dim_in, dim_out, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Conv1x1(nn.Conv2d):
    """A 1x1 conv (weight (O, I, 1, 1)) applied as a Linear on NHWC's trailing axis."""

    def __init__(self, dim_in, dim_out, bias=True, dtype=F32):
        super().__init__(dim_in, dim_out, 1, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.flatten(1).to(dt), b)


class Conv2d(nn.Conv2d):
    """nn.Conv2d on NHWC tensors. The permuted view is channels_last-strided,
    so cuDNN takes it without a copy and the NHWC result is a free permute.
    The weight may also be a unit-time Conv3d's (O, I, 1, kh, kw), as the
    video U-Net holds it (`video_blocks.unit_time`)."""

    def __init__(self, dim_in, dim_out, kernel_size, stride=1, padding=0, dtype=F32):
        super().__init__(dim_in, dim_out, kernel_size, stride=stride, padding=padding)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        w = self.weight.reshape(*self.weight.shape[:2], *self.weight.shape[-2:])
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), w.to(dt), self.bias.to(dt),
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class SameConv3x3(Conv2d):
    """3x3 SAME conv; dispatches to the conv kernel (ops/conv2d.py) on the
    shapes its gate admits, else to F.conv2d."""

    def __init__(self, dim_in, dim_out, dtype=F32):
        super().__init__(dim_in, dim_out, 3, padding=1, dtype=dtype)

    def forward(self, x):
        dt = self.compute_dtype
        x = x.to(dt)
        w_shape = (3, 3, self.in_channels, self.out_channels)
        if conv2d_same_available(tuple(x.shape), w_shape, dt, x.device.type):
            return conv2d_same(x, self.weight.to(dt).permute(2, 3, 1, 0), self.bias)
        return super().forward(x)


# --- norms ------------------------------------------------------------------------------

class LayerNorm(nn.Module):
    """Bias-free LayerNorm (gain 'g'); eps 1e-5 in fp32, 1e-3 in half.

    With `time_fold` it takes video (b, f, h, w, c) and returns the normalised
    ((b h w), f, c) tokens of the temporal attention, through kernel 12
    (ops/temporal_layout.py): the same math followed by the fold."""

    def __init__(self, dim, stable=False):
        super().__init__()
        self.stable = stable
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x, time_fold=False):
        if time_fold:
            if x.ndim != 5 or self.stable:
                raise ValueError('time_fold takes (b, f, h, w, c) input and stable=False')
            return fused_ln_transpose(x, self.g, ln_eps(x.dtype))
        if self.stable:
            x = x / x.amax(dim=-1, keepdim=True).detach()
        return layernorm(x, self.g, ln_eps(x.dtype))


class ChanRMSNorm(nn.Module):
    """Channel RMSNorm on NHWC's trailing axis, with the FiLM and SiLU that
    follow it in Block applied in the same call.

    With `fused`, a call with the SiLU whose shape `fused_film_available`
    admits runs the whole norm -> FiLM -> SiLU chain as kernel 8
    (ops/fused_norm.py), in fp32 with one rounding at the end: the JAX
    `IMAGEN_TPU_FUSED_FILM=1` route. The parameter is the same either way."""

    def __init__(self, dim, fused=False):
        super().__init__()
        self.fused = fused
        self.gamma = nn.Parameter(torch.ones(dim, 1, 1))

    def forward(self, x, scale_shift=None, fuse_silu=False):
        dim = x.shape[-1]
        if self.fused and fused_film_available(x.shape, x.dtype, x.device.type, fuse_silu):
            scale, shift = scale_shift if exists(scale_shift) else (None, None)
            return fused_film_norm(x, self.gamma, scale, shift)
        out = l2norm(x, dim=-1) * (dim ** 0.5) * self.gamma.view(-1).to(x.dtype)
        if exists(scale_shift):
            scale, shift = scale_shift
            out = out * (scale + 1) + shift
        if fuse_silu:
            out = F.silu(out)
        return out


class TorchLayerNorm(nn.LayerNorm):
    """nn.LayerNorm (eps 1e-5, weight + bias) with fp32 statistics, output in
    `dtype`. The variance is E[x^2] - E[x]^2, as flax `nn.LayerNorm` takes it."""

    def __init__(self, dim, dtype=F32):
        super().__init__(dim, eps=1e-5)
        self.compute_dtype = dtype

    def forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, F32))
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp(min=0.)
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(self.compute_dtype)


# --- feedforward ------------------------------------------------------------------------

class KeepsPacked:
    """A module mixin that keeps what it makes from its parameters for a
    kernel (bf16 or packed weights) while no gradient is wanted. The value is
    made again when a parameter is replaced, changed in place (its version)
    or given new data (its pointer), and dropped when the module moves
    (`_apply`: `.to()`, `.cuda()`, ...); a change made through `.data` in
    place is not seen."""

    _kept = None   # (parameters, their stamps, the value made from them)

    def _apply(self, fn, *args, **kwargs):
        self._kept = None
        return super()._apply(fn, *args, **kwargs)

    def kept(self, params, make):
        """`make()`, or the value it gave last while `params` are unchanged."""
        params = tuple(params)
        stamp = [(p._version, p.data_ptr()) for p in params]
        cached = self._kept
        if (cached is None or cached[1] != stamp
                or any(p is not q for p, q in zip(cached[0], params))):
            self._kept = cached = (params, stamp, make())
        return cached[2]


class FeedForward(KeepsPacked, nn.Sequential):
    """LayerNorm -> Linear -> GELU -> LayerNorm -> Linear, no biases.

    Where the gate admits the shape the whole chain runs as one kernel
    (ops/fused_norm.py); the parameters are the same either way. Without a
    gradient the kernel's bf16 weights are kept until a weight changes or the
    module moves."""

    def __init__(self, dim, mult=2., dtype=F32):
        hidden_dim = int(dim * mult)
        super().__init__(
            LayerNorm(dim),
            Linear(dim, hidden_dim, bias=False, dtype=dtype),
            nn.GELU(),
            LayerNorm(hidden_dim),
            Linear(hidden_dim, dim, bias=False, dtype=dtype),
        )
        self.compute_dtype = dtype

    def _packed_weights(self):
        """`pack_ff_weights` of the two Linear weights, kept (`KeepsPacked`)."""
        ws = (self[1].weight, self[4].weight)
        return self.kept(ws, lambda: pack_ff_weights(*ws))

    def forward(self, x):
        dt = self.compute_dtype
        x = x.to(dt)
        dim, hidden_dim = self[1].in_features, self[1].out_features
        if fused_feedforward_available(x.numel() // dim, dim, hidden_dim, dt,
                                       x.device.type):
            args = (x, self[0].g, self[1].weight, self[3].g, self[4].weight, ln_eps(dt))
            if x.is_cuda and not wants_grad(x, *self.parameters()):
                return fused_feedforward(*args, packed=self._packed_weights())
            return fused_feedforward(*args)
        return super().forward(x)


# --- time embeddings --------------------------------------------------------------------

class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        half_dim = self.dim // 2
        emb = math.log(10000) / (half_dim - 1)
        emb = torch.exp(torch.arange(half_dim, device=x.device) * -emb)
        emb = x[:, None] * emb[None, :]
        return torch.cat((emb.sin(), emb.cos()), dim=-1)


class LearnedSinusoidalPosEmb(nn.Module):
    """Learned random-fourier time embedding with the raw t concatenated."""

    def __init__(self, dim):
        super().__init__()
        if dim % 2:
            raise ValueError('LearnedSinusoidalPosEmb needs an even dim')
        self.weights = nn.Parameter(torch.randn(dim // 2))

    def forward(self, x):
        x = x[:, None]
        freqs = x * self.weights[None, :] * 2 * math.pi
        return torch.cat((x, freqs.sin(), freqs.cos()), dim=-1)


# --- attention --------------------------------------------------------------------------

class Attention(nn.Module):
    """Multi-query self attention with null KV and optional context tokens
    prepended to K/V; cosine-sim QK with learned per-dim scales, fp32 softmax."""

    def __init__(self, dim, dim_head=64, heads=8, context_dim=None, scale=8., dtype=F32):
        super().__init__()
        inner_dim = dim_head * heads
        self.heads, self.scale = heads, scale
        self.norm = LayerNorm(dim)
        self.null_kv = nn.Parameter(torch.randn(2, dim_head))
        self.to_q = Linear(dim, inner_dim, bias=False, dtype=dtype)
        self.to_kv = Linear(dim, dim_head * 2, bias=False, dtype=dtype)
        self.q_scale = nn.Parameter(torch.ones(dim_head))
        self.k_scale = nn.Parameter(torch.ones(dim_head))
        self.to_context = nn.Sequential(
            TorchLayerNorm(context_dim, dtype=dtype),
            Linear(context_dim, dim_head * 2, dtype=dtype),
        ) if exists(context_dim) else None
        self.to_out = nn.Sequential(Linear(inner_dim, dim, bias=False, dtype=dtype),
                                    LayerNorm(dim))

    def forward(self, x, context=None, mask=None, attn_bias=None):
        b = x.shape[0]
        x = self.norm(x)
        q = self.to_q(x)
        k, v = self.to_kv(x).chunk(2, dim=-1)

        nk = self.null_kv[0].to(k.dtype).expand(b, 1, -1)
        nv = self.null_kv[1].to(v.dtype).expand(b, 1, -1)
        k = torch.cat((nk, k), dim=-2)
        v = torch.cat((nv, v), dim=-2)

        num_prepended = 1
        if exists(context):
            if self.to_context is None:
                raise ValueError('Attention got context but has no context_dim')
            ck, cv = self.to_context(context).chunk(2, dim=-1)
            k = torch.cat((ck, k), dim=-2)
            v = torch.cat((cv, v), dim=-2)
            num_prepended += ck.shape[-2]

        out = multiquery_attention_packed(
            q, k, v, self.heads, scale=self.scale, mask=mask, attn_bias=attn_bias,
            null_tokens=num_prepended, q_scale=self.q_scale, k_scale=self.k_scale)
        return self.to_out(out)


def _split_heads(t, heads):
    b, n, hd = t.shape
    return t.reshape(b, n, heads, hd // heads).transpose(1, 2)


def _merge_heads(t):
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d)


class CrossAttention(nn.Module):
    """Full multi-head cross-attention over conditioning tokens (the
    non-linear branch of the JAX module)."""

    def __init__(self, dim, context_dim=None, dim_head=64, heads=8, norm_context=False,
                 scale=8., linear=False, dtype=F32):
        super().__init__()
        if linear:
            raise NotImplementedError('linear cross-attention is not ported yet')
        context_dim = default(context_dim, dim)
        inner_dim = dim_head * heads
        self.heads, self.scale = heads, scale
        self.norm = LayerNorm(dim)
        self.norm_context = LayerNorm(context_dim) if norm_context else None
        self.null_kv = nn.Parameter(torch.randn(2, dim_head))
        self.to_q = Linear(dim, inner_dim, bias=False, dtype=dtype)
        self.to_kv = Linear(context_dim, inner_dim * 2, bias=False, dtype=dtype)
        self.q_scale = nn.Parameter(torch.ones(dim_head))
        self.k_scale = nn.Parameter(torch.ones(dim_head))
        self.to_out = nn.Sequential(Linear(inner_dim, dim, bias=False, dtype=dtype),
                                    LayerNorm(dim))

    def forward(self, x, context, mask=None):
        b = x.shape[0]
        if exists(self.norm_context):
            context = self.norm_context(context)
        x = self.norm(x)
        q = _split_heads(self.to_q(x), self.heads)
        k, v = (_split_heads(t, self.heads) for t in self.to_kv(context).chunk(2, dim=-1))

        nk = self.null_kv[0].to(k.dtype).expand(b, self.heads, 1, -1)
        nv = self.null_kv[1].to(v.dtype).expand(b, self.heads, 1, -1)
        k = torch.cat((nk, k), dim=-2)
        v = torch.cat((nv, v), dim=-2)

        q = l2norm(q) * self.q_scale.to(q.dtype)
        k = l2norm(k) * self.k_scale.to(k.dtype)

        out = multihead_attention(q, k, v, scale=self.scale, mask=mask, null_tokens=1)
        return self.to_out(_merge_heads(out))


class GlobalContext(nn.Module):
    """Softmax spatial pool -> bottleneck MLP -> sigmoid gate of shape (b, 1, 1, dim_out)."""

    def __init__(self, dim_in, dim_out, dtype=F32):
        super().__init__()
        hidden_dim = max(3, dim_out // 2)
        self.to_k = Conv1x1(dim_in, 1, dtype=dtype)
        self.net = nn.Sequential(
            Conv1x1(dim_in, hidden_dim, dtype=dtype),
            nn.SiLU(),
            Conv1x1(hidden_dim, dim_out, dtype=dtype),
            nn.Sigmoid(),
        )

    def forward(self, x):
        b, h, w, c = x.shape
        context = self.to_k(x).reshape(b, h * w, 1)
        attn = torch.softmax(context, dim=-2)
        pooled = torch.einsum('bni,bnc->bic', attn, x.reshape(b, h * w, c).to(attn.dtype))
        return self.net(pooled[:, :, None, :])


# --- resnet -----------------------------------------------------------------------------

class Block(nn.Module):
    """ChanRMSNorm -> (FiLM scale/shift) -> SiLU -> 3x3 conv; `fused_film`
    lets the norm take kernel 8."""

    def __init__(self, dim, dim_out, norm=True, dtype=F32, fused_film=False):
        super().__init__()
        self.norm = ChanRMSNorm(dim, fused=fused_film) if norm else None
        self.project = SameConv3x3(dim, dim_out, dtype=dtype)

    def forward(self, x, scale_shift=None):
        if exists(self.norm):
            x = self.norm(x, scale_shift=scale_shift, fuse_silu=True)
        else:
            if exists(scale_shift):
                scale, shift = scale_shift
                x = x * (scale + 1) + shift
            x = F.silu(x)
        return self.project(x)


class ResnetBlock(nn.Module):
    """Time-FiLM'd double conv block with optional cross-attention and
    GlobalContext gate."""

    def __init__(self, dim, dim_out, cond_dim=None, time_cond_dim=None, linear_attn=False,
                 use_gca=False, attn_dim_head=64, attn_heads=8, dtype=F32, fused_film=False):
        super().__init__()
        self.time_mlp = nn.Sequential(
            nn.SiLU(), Linear(time_cond_dim, dim_out * 2, dtype=dtype),
        ) if exists(time_cond_dim) else None
        self.cross_attn = CrossAttention(
            dim_out, context_dim=cond_dim, dim_head=attn_dim_head, heads=attn_heads,
            linear=linear_attn, dtype=dtype) if exists(cond_dim) else None
        self.block1 = Block(dim, dim_out, dtype=dtype, fused_film=fused_film)
        self.block2 = Block(dim_out, dim_out, dtype=dtype, fused_film=fused_film)
        self.gca = GlobalContext(dim_out, dim_out, dtype=dtype) if use_gca else None
        self.res_conv = Conv1x1(dim, dim_out, dtype=dtype) if dim != dim_out else None

    def forward(self, x, time_emb=None, cond=None):
        scale_shift = None
        if exists(self.time_mlp) and exists(time_emb):
            t = self.time_mlp(time_emb)
            scale_shift = t[:, None, None, :].chunk(2, dim=-1)

        h = self.block1(x)

        if exists(self.cross_attn):
            if not exists(cond):
                raise ValueError('ResnetBlock with cross-attention needs cond')
            b, hh, ww, c = h.shape
            h_flat = h.reshape(b, hh * ww, c)
            h_flat = self.cross_attn(h_flat, context=cond) + h_flat
            h = h_flat.reshape(b, hh, ww, c)

        h = self.block2(h, scale_shift=scale_shift)

        if exists(self.gca):
            h = h * self.gca(h)

        if exists(self.res_conv):
            x = self.res_conv(x)
        return h + x


class TransformerBlock(nn.Module):
    """Flatten the fmap to tokens; depth x (multi-query attention + FF) residual layers."""

    def __init__(self, dim, depth=1, heads=8, dim_head=32, ff_mult=2., context_dim=None,
                 dtype=F32):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.ModuleList([
                Attention(dim, heads=heads, dim_head=dim_head, context_dim=context_dim,
                          dtype=dtype),
                FeedForward(dim, mult=ff_mult, dtype=dtype),
            ]) for _ in range(depth)])

    def forward(self, x, context=None):
        b, hh, ww, c = x.shape
        x = x.reshape(b, hh * ww, c)
        for attn, ff in self.layers:
            x = attn(x, context=context) + x
            x = ff(x) + x
        return x.reshape(b, hh, ww, -1)


# --- resolution changers -----------------------------------------------------------------

class NearestUpsample2x(nn.Module):
    def forward(self, x):
        return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class Upsample(nn.Sequential):
    """Nearest x2 + 3x3 conv."""

    def __init__(self, dim, dim_out, dtype=F32):
        super().__init__(NearestUpsample2x(), Conv2d(dim, dim_out, 3, padding=1, dtype=dtype))


class PixelShuffle2x(nn.Module):
    """F.pixel_shuffle on NHWC: channel index (c s1 s2) -> 2x2 spatial block."""

    def forward(self, x):
        return F.pixel_shuffle(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


class PixelShuffleUpsample(nn.Module):
    """1x1 conv -> SiLU -> pixel shuffle x2, with the conv's kaiming init
    sampled at dim_out and replicated across the four shuffle groups."""

    def __init__(self, dim, dim_out, dtype=F32):
        super().__init__()
        conv = Conv1x1(dim, dim_out * 4, dtype=dtype)
        self.net = nn.Sequential(conv, nn.SiLU(), PixelShuffle2x())
        with torch.no_grad():
            w = torch.empty(dim_out, dim, 1, 1, device=conv.weight.device)
            nn.init.kaiming_uniform_(w)
            conv.weight.copy_(w.repeat_interleave(4, dim=0))
            conv.bias.zero_()

    def forward(self, x):
        return self.net(x)


class SpaceToDepth2x(nn.Module):
    """'b (h s1) (w s2) c -> b h w (c s1 s2)' on NHWC."""

    def forward(self, x):
        b, h, w, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
        return x.reshape(b, h // 2, w // 2, c * 4)


class Downsample(nn.Sequential):
    """Space-to-depth, then a Linear (the 1x1 conv of the SP-conv)."""

    def __init__(self, dim, dim_out, dtype=F32):
        super().__init__(SpaceToDepth2x(), Conv1x1(dim * 4, dim_out, dtype=dtype))


class Parallel(nn.Module):
    """Sum of parallel branches (the last down level's Conv3x3 + Conv1x1)."""

    def __init__(self, *fns):
        super().__init__()
        self.fns = nn.ModuleList(fns)

    def forward(self, x):
        return sum(fn(x) for fn in self.fns)


class CrossEmbedLayer(KeepsPacked, nn.Module):
    """Multi-kernel-size conv, channels split per scale, concatenated.

    A stride-1 call whose shape `stem_available` admits runs every scale,
    the concatenation and the bias as kernel 14 (ops/stem_conv.py); the
    parameters are the same either way. Without a gradient the kernel's
    packed weights are kept until a parameter changes or the layer moves."""

    def __init__(self, dim_in, kernel_sizes, dim_out=None, stride=2, dtype=F32):
        super().__init__()
        if not all((k % 2) == (stride % 2) for k in kernel_sizes):
            raise ValueError('kernel sizes must share the stride parity')
        dim_out = default(dim_out, dim_in)
        kernel_sizes = sorted(kernel_sizes)
        num_scales = len(kernel_sizes)
        dim_scales = [int(dim_out / (2 ** i)) for i in range(1, num_scales)]
        dim_scales = [*dim_scales, dim_out - sum(dim_scales)]
        self.convs = nn.ModuleList([
            Conv2d(dim_in, dim_scale, kernel, stride=stride,
                   padding=(kernel - stride) // 2, dtype=dtype)
            for kernel, dim_scale in zip(kernel_sizes, dim_scales)])
        self.kernel_sizes = kernel_sizes
        self.stride = stride

    def _stem_args(self, dt):
        """The kernel's (k, k, c, d) weights in `dt` and the concatenated bias;
        a unit-time video weight (O, I, 1, k, k) is read as (O, I, k, k)."""
        ws = [conv.weight.reshape(*conv.weight.shape[:2], k, k).to(dt).permute(2, 3, 1, 0)
              for conv, k in zip(self.convs, self.kernel_sizes)]
        return ws, torch.cat([conv.bias for conv in self.convs])

    def _cached_stem_args(self, dt, device_type):
        """`_stem_args` and the packed weights, kept (`KeepsPacked`)."""
        def make():
            ws, bias = self._stem_args(dt)
            return ws, bias.to(dt), pack_stem_weights(ws) if device_type == 'cuda' else None
        return self.kept(self.parameters(), make)

    def forward(self, x):
        dt = self.convs[0].compute_dtype
        if self.stride == 1 and stem_available(tuple(x.shape), self.kernel_sizes, dt,
                                               x.device.type):
            x = x.to(dt)
            if wants_grad(x, *self.parameters()):
                return cross_embed_stem(x, *self._stem_args(dt))
            ws, bias, packed = self._cached_stem_args(dt, x.device.type)
            return cross_embed_stem(x, ws, bias, packed=packed)
        return torch.cat([conv(x) for conv in self.convs], dim=-1)


class UpsampleCombiner(nn.Module):
    """Optionally resize + Block every upsample-stage fmap and concat them at the end."""

    def __init__(self, dim, enabled=False, dim_ins=tuple(), dim_outs=tuple(), dtype=F32,
                 fused_film=False):
        super().__init__()
        dim_outs = cast_tuple(dim_outs, len(dim_ins))
        self.enabled = enabled
        self.fmap_convs = nn.ModuleList([
            Block(dim_in, dim_out, dtype=dtype, fused_film=fused_film)
            for dim_in, dim_out in zip(dim_ins, dim_outs)
        ]) if enabled else nn.ModuleList()
        self.dim_out = dim + (sum(dim_outs) if enabled and len(dim_outs) > 0 else 0)

    def forward(self, x, fmaps=None):
        fmaps = default(fmaps, tuple())
        if not self.enabled or len(fmaps) == 0 or len(self.fmap_convs) == 0:
            return x
        target_size = x.shape[-2]
        outs = [conv(resize_image_to(fmap, target_size))
                for fmap, conv in zip(fmaps, self.fmap_convs)]
        return torch.cat((x, *outs), dim=-1)


# --- perceiver resampler -----------------------------------------------------------------

class PerceiverAttention(nn.Module):
    """Latents attend over (sequence ++ latents)."""

    def __init__(self, dim, dim_head=64, heads=8, scale=8., dtype=F32):
        super().__init__()
        inner_dim = dim_head * heads
        self.heads, self.scale = heads, scale
        self.norm = TorchLayerNorm(dim, dtype=dtype)
        self.norm_latents = TorchLayerNorm(dim, dtype=dtype)
        self.to_q = Linear(dim, inner_dim, bias=False, dtype=dtype)
        self.to_kv = Linear(dim, inner_dim * 2, bias=False, dtype=dtype)
        self.q_scale = nn.Parameter(torch.ones(dim_head))
        self.k_scale = nn.Parameter(torch.ones(dim_head))
        self.to_out = nn.Sequential(Linear(inner_dim, dim, bias=False, dtype=dtype),
                                    TorchLayerNorm(dim, dtype=dtype))

    def forward(self, x, latents, mask=None):
        x = self.norm(x)
        latents = self.norm_latents(latents)
        q = _split_heads(self.to_q(latents), self.heads)
        kv_input = torch.cat((x, latents), dim=-2)
        k, v = (_split_heads(t, self.heads) for t in self.to_kv(kv_input).chunk(2, dim=-1))

        q = l2norm(q) * self.q_scale.to(q.dtype)
        k = l2norm(k) * self.k_scale.to(k.dtype)

        if exists(mask):
            mask = F.pad(mask, (0, latents.shape[-2]), value=True)

        out = multihead_attention(q, k, v, scale=self.scale, mask=mask, null_tokens=0)
        return self.to_out(_merge_heads(out))


class PerceiverResampler(nn.Module):
    """Attention-pool text tokens into a fixed set of latents (+ mean-pooled latents)."""

    def __init__(self, dim, depth, dim_head=64, heads=8, num_latents=64,
                 num_latents_mean_pooled=4, max_seq_len=512, ff_mult=4., dtype=F32):
        super().__init__()
        self.compute_dtype = dtype
        self.num_latents_mean_pooled = num_latents_mean_pooled
        self.pos_emb = nn.Embedding(max_seq_len, dim)
        self.latents = nn.Parameter(torch.randn(num_latents, dim))
        self.to_latents_from_mean_pooled_seq = nn.Sequential(
            LayerNorm(dim),
            Linear(dim, dim * num_latents_mean_pooled, dtype=dtype),
        ) if num_latents_mean_pooled > 0 else None
        self.layers = nn.ModuleList([
            nn.ModuleList([
                PerceiverAttention(dim, dim_head=dim_head, heads=heads, dtype=dtype),
                FeedForward(dim, mult=ff_mult, dtype=dtype),
            ]) for _ in range(depth)])

    def forward(self, x, mask=None):
        b, n, dim = x.shape
        pos_emb = self.pos_emb(torch.arange(n, device=x.device)).to(self.compute_dtype)
        x_with_pos = x + pos_emb

        latents = self.latents.to(x.dtype).expand(b, -1, -1)

        if exists(self.to_latents_from_mean_pooled_seq):
            meanpooled_seq = masked_mean(
                x, dim=1, mask=torch.ones(x.shape[:2], dtype=torch.bool, device=x.device))
            mp = self.to_latents_from_mean_pooled_seq(meanpooled_seq)
            mp_latents = mp.reshape(b, self.num_latents_mean_pooled, dim)
            latents = torch.cat((mp_latents, latents), dim=-2)

        for attn, ff in self.layers:
            latents = attn(x_with_pos, latents, mask=mask) + latents
            latents = ff(latents) + latents
        return latents
