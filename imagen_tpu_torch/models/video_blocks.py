"""Video (pseudo-3D) building blocks (torch.nn, NFHWC: batch, frames, height,
width, channels); counterpart of `imagen_tpu/models/video_blocks.py`.

- Frames fold into the batch for every spatial op, so the 2D blocks of
  `models/blocks.py` serve per frame; the genuinely temporal modules (causal
  temporal conv, temporal PEG, causal temporal attention with a continuous
  relative position bias, the token-shift feedforward, temporal up- and
  downsampling) are here.
- Parameters keep lucidrains' `imagen_video` key names and torch shapes.
  Its video `Conv2d` is an `nn.Conv3d` with a unit time kernel, so the 2D
  blocks' convs are given 5-D weights (O, I, 1, kh, kw) by `unit_time`;
  the pseudo-3D conv keeps a 2D conv's (O, I, kh, kw) and a Conv1d's.
- Where the JAX package departs from lucidrains the port follows it: the
  causal temporal conv starts as a true identity (delta at the last tap), and
  `null_attn_bias` exists only where a relative position bias uses it.
- The JAX package's `IMAGEN_TPU_TEMPORAL_FUSED_LN` switch is carried as
  the constructor keyword `fused_ln` of `TemporalAttention` (`Unet3D`'s
  `temporal_fused_ln`), off by default as there: the temporal LayerNorm
  then folds to ((b h w), f, c) in kernel 12 and the out-norm unfolds and
  adds the residual in kernel 13 (ops/temporal_layout.py). Its TPU-only
  switches `IMAGEN_TPU_TEMPORAL_EINSUM` and `IMAGEN_TPU_TEMPORAL_ROWS` are
  not carried: the projections are plain Linears.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from imagen_tpu_torch.models.blocks import (
    F32,
    Attention,
    ChanLayerNorm,
    ChanRMSNorm,
    Conv1x1,
    Conv2d,
    CrossAttention,
    GlobalContext,
    LayerNorm,
    Linear,
    LinearAttention,
    SameConv3x3,
    TorchLayerNorm,
    recomputed,
    unit_time,
)
from imagen_tpu_torch.ops.attention import video_attention
from imagen_tpu_torch.ops.temporal_layout import temporal_residual
from imagen_tpu_torch.ops.tensor_utils import resize_axes, resize_kernel
from imagen_tpu_torch.utils.helpers import cast_tuple, default, exists
from imagen_tpu_torch.utils.profiling import span


# --- video resize helpers -------------------------------------------------------------------

def resize_video_to(video, target_image_size, target_frames=None, clamp_range=None,
                    method='nearest'):
    """Resize of NFHWC video to a square size and, optionally, another frame
    count, with a `jax.image.resize` method (`resize_axes`, in time and
    space at once). Nearest is 'nearest-exact', which samples at half-pixel
    centres on every axis, frames included, as `jax.image.resize` does."""
    b, f, h, w, c = video.shape
    target_frames = default(target_frames, f)
    target = (target_frames, target_image_size, target_image_size)
    if (f, h, w) == target:
        return video
    if resize_kernel(method) is None:
        out = F.interpolate(video.permute(0, 4, 1, 2, 3), size=target,
                            mode='nearest-exact').permute(0, 2, 3, 4, 1)
    else:
        out = resize_axes(video, dict(zip((1, 2, 3), target)), method)
    if exists(clamp_range):
        out = out.clamp(*clamp_range)
    return out


def scale_video_time(video, downsample_scale=1, method='nearest'):
    """Temporal downsample of conditioning frames."""
    if downsample_scale == 1:
        return video
    frames = video.shape[1]
    if frames % downsample_scale:
        raise ValueError(f'{frames} frames not divisible by temporal downsample '
                         f'{downsample_scale}')
    return resize_video_to(video, video.shape[-2], target_frames=frames // downsample_scale,
                           method=method)


# --- frame folding --------------------------------------------------------------------------

def fold_frames(x):
    """(b, f, h, w, c) -> ((b f), h, w, c), and b."""
    return x.reshape(-1, *x.shape[2:]), x.shape[0]


def unfold_frames(x, b):
    return x.reshape(b, -1, *x.shape[1:])


def spatial(module, x, *args, **kwargs):
    """Apply a 2D NHWC module per frame."""
    folded, b = fold_frames(x)
    return unfold_frames(module(folded, *args, **kwargs), b)


def _shift_frames(x, s):
    """x[:, f - s] at frame f, zeros before the first frame."""
    if s == 0:
        return x
    return F.pad(x, (0, 0, 0, 0, 0, 0, s, 0))[:, :x.shape[1]]


# --- pseudo-3D conv -------------------------------------------------------------------------

class CausalTemporalConv(nn.Conv1d):
    """The causal temporal conv of `PseudoConv3d` over (b, f, h, w, c):
    out[f] = sum_j x[f + j - (k - 1)] W[:, :, j] + bias, zeros before the
    first frame, as one product over the k shifted copies stacked on the
    channel axis. It starts as the identity: a delta at its last tap, which
    with left-only padding passes each frame through."""

    def __init__(self, dim, kernel_size, dtype=F32):
        super().__init__(dim, dim, kernel_size)
        self.compute_dtype = dtype
        with torch.no_grad():
            self.weight.zero_()
            self.weight[:, :, -1] = torch.eye(dim)
            self.bias.zero_()

    def forward(self, x):
        dt = self.compute_dtype
        o, i, tk = self.weight.shape
        xs = torch.cat([_shift_frames(x, tk - 1 - j) for j in range(tk)], dim=-1)
        return F.linear(xs, self.weight.permute(0, 2, 1).reshape(o, tk * i).to(dt),
                        self.bias.to(dt))


class PseudoConv3d(nn.Module):
    """Spatial k x k conv per frame (a 3x3 through `SameConv3x3`'s gate),
    then a causal temporal conv over frames per pixel, in a `video.temporal`
    span."""

    def __init__(self, dim, dim_out, kernel_size=3, temporal_kernel_size=None, dtype=F32):
        super().__init__()
        self.spatial_conv = SameConv3x3(dim, dim_out, dtype=dtype) if kernel_size == 3 else \
            Conv2d(dim, dim_out, kernel_size, padding=kernel_size // 2, dtype=dtype)
        self.temporal_conv = CausalTemporalConv(
            dim_out, default(temporal_kernel_size, kernel_size), dtype=dtype) \
            if kernel_size > 1 else None

    def forward(self, x, ignore_time=False):
        if x.ndim != 5:
            return self.spatial_conv(x)
        x = spatial(self.spatial_conv, x)
        if ignore_time or self.temporal_conv is None:
            return x
        with span('video.temporal'):
            return self.temporal_conv(x)


class SpatialConvIn3d(Conv2d):
    """lucidrains' video `Conv2d`: a (1, k, k) Conv3d (weight (O, I, 1, k, k)),
    i.e. a 2D conv with the frames folded into the batch. SAME padding at
    stride 1."""

    def __init__(self, dim, dim_out, kernel=1, stride=1, dtype=F32):
        pad = kernel // 2 if stride == 1 else (kernel - stride) // 2
        super().__init__(dim, dim_out, kernel, stride=stride, padding=pad, dtype=dtype)
        unit_time(self)

    def forward(self, x):
        if x.ndim == 5:
            return spatial(super().forward, x)
        return super().forward(x)


# --- temporal attention ---------------------------------------------------------------------

class DynamicPositionBias(nn.Module):
    """Continuous relative position bias: an MLP of the frame offset, giving
    a (heads, n, n) bias for attention over n frames."""

    def __init__(self, dim, heads, depth=2, dtype=F32):
        super().__init__()

        def hidden(dim_in):
            return nn.Sequential(Linear(dim_in, dim, dtype=dtype), LayerNorm(dim), nn.SiLU())

        self.mlp = nn.Sequential(hidden(1), *(hidden(dim) for _ in range(max(depth - 1, 0))),
                                 Linear(dim, heads, dtype=dtype))

    def forward(self, n, device):
        pos = torch.arange(-n + 1, n, device=device, dtype=torch.float32)[:, None]
        pos = self.mlp(pos)                                 # (2n - 1, heads)
        i = torch.arange(n, device=device)
        indices = i[:, None] - i[None, :] + (n - 1)
        return pos[indices].permute(2, 0, 1)                 # (heads, n, n)


class VideoAttention(nn.Module):
    """Multi-query cosine-sim attention with optional causality, a relative
    position bias with a learned null-key bias, context tokens and a gain-only
    output norm (zero at init with `init_zero`). `ops.attention.video_attention`
    routes the attention, as the JAX module does: to the flash rows kernel,
    to the temporal kernel or to the plain core."""

    def __init__(self, dim, dim_head=64, heads=8, causal=False, context_dim=None,
                 rel_pos_bias=False, rel_pos_bias_mlp_depth=2, init_zero=False, scale=8.,
                 dtype=F32):
        super().__init__()
        inner_dim = dim_head * heads
        self.heads, self.dim_head, self.causal, self.scale = heads, dim_head, causal, scale
        self.norm = LayerNorm(dim)
        self.to_q = Linear(dim, inner_dim, bias=False, dtype=dtype)
        self.to_kv = Linear(dim, dim_head * 2, bias=False, dtype=dtype)
        self.null_kv = nn.Parameter(torch.randn(2, dim_head))
        self.to_context = nn.Sequential(
            TorchLayerNorm(context_dim, dtype=dtype),
            Linear(context_dim, dim_head * 2, dtype=dtype),
        ) if exists(context_dim) else None
        self.q_scale = nn.Parameter(torch.ones(dim_head))
        self.k_scale = nn.Parameter(torch.ones(dim_head))
        self.rel_pos_bias = DynamicPositionBias(
            dim, heads, depth=rel_pos_bias_mlp_depth, dtype=dtype) if rel_pos_bias else None
        self.null_attn_bias = nn.Parameter(torch.randn(heads)) if rel_pos_bias else None
        self.to_out = nn.Sequential(Linear(inner_dim, dim, bias=False, dtype=dtype),
                                    LayerNorm(dim))
        if init_zero:
            nn.init.zeros_(self.to_out[1].g)

    def forward(self, x, context=None, mask=None):
        return self.to_out(self.attend(self.norm(x), context, mask))

    def attend(self, x, context=None, mask=None):
        """The attention of normalised tokens x (B, n, dim), heads merged,
        before the out projection: (B, n, heads * dim_head)."""
        b, n, _ = x.shape
        q = self.to_q(x)
        k, v = self.to_kv(x).chunk(2, dim=-1)
        k = torch.cat((self.null_kv[0].to(k.dtype).expand(b, 1, -1), k), dim=-2)
        v = torch.cat((self.null_kv[1].to(v.dtype).expand(b, 1, -1), v), dim=-2)

        num_prepended = 1
        if exists(context):
            if self.to_context is None:
                raise ValueError('VideoAttention got context but has no context_dim')
            ck, cv = self.to_context(context).chunk(2, dim=-1)
            k = torch.cat((ck, k), dim=-2)
            v = torch.cat((cv, v), dim=-2)
            num_prepended += ck.shape[-2]

        # per-pixel additive bias (heads, n, nk) with the null column first
        bias = None
        if exists(self.rel_pos_bias):
            rel = self.rel_pos_bias(n, x.device).float()
            null = self.null_attn_bias.float()[:, None, None].expand(self.heads, n, 1)
            bias = torch.cat((null, rel), dim=-1)
        per_pixel = not (exists(context) or exists(mask))
        return video_attention(q, k, v, self.heads, scale=self.scale, q_scale=self.q_scale,
                               k_scale=self.k_scale, per_pixel=per_pixel, causal=self.causal,
                               bias=bias, mask=mask, null_tokens=num_prepended)


class _TimeCentric(nn.Module):
    """'b f h w c -> (b h w) f c' around `fn`, and back."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        b, f, hh, ww, c = x.shape
        xt = x.permute(0, 2, 3, 1, 4).reshape(b * hh * ww, f, c)
        out = self.fn(xt)
        return out.reshape(b, hh, ww, f, -1).permute(0, 3, 1, 2, 4)


class Residual(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x) + x


class TemporalAttention(Residual):
    """Residual causal attention over frames, per pixel, with a relative
    position bias; zero-initialised output gain.

    With `fused_ln`, a site whose shape the gate admits takes kernels 12
    and 13 (`ops.temporal_layout.temporal_residual`): the in-norm folds to
    ((b h w), f, c) as it normalises, and the out-norm unfolds and adds the
    residual. Other sites, and every site without it, fold and unfold around
    the attention here. The parameters are the same on both routes."""

    def __init__(self, dim, dim_head=64, heads=8, causal=True, rel_pos_bias_mlp_depth=2,
                 fused_ln=False, dtype=F32):
        super().__init__(_TimeCentric(VideoAttention(
            dim, dim_head=dim_head, heads=heads, causal=causal, init_zero=True,
            rel_pos_bias=True, rel_pos_bias_mlp_depth=rel_pos_bias_mlp_depth, dtype=dtype)))
        self.fused_ln = fused_ln

    def forward(self, x):
        attn = self.fn.fn
        return temporal_residual(x, attn.norm.g, lambda t: attn.to_out[0](attn.attend(t)),
                                 attn.to_out[1].g, plain=lambda: Residual.forward(self, x),
                                 fused=self.fused_ln)


class TemporalPeg(nn.Module):
    """Residual depthwise (3, 1, 1) conv over frames, causally padded (two
    frames before the first) or centred. The weight is the nn.Conv3d's
    (C, 1, 3, 1, 1) at `fn.1` (`fn.0` stands where lucidrains pads)."""

    def __init__(self, dim, causal=True, dtype=F32):
        super().__init__()
        self.compute_dtype = dtype
        self.causal = causal
        self.fn = nn.Sequential(nn.Identity(), nn.Conv3d(dim, dim, (3, 1, 1), groups=dim))
        nn.init.zeros_(self.fn[1].bias)

    def forward(self, x):
        conv, dt = self.fn[1], self.compute_dtype
        w = conv.weight[:, 0, :, 0, 0].to(dt).float()        # (C, 3), taps in dt
        f = x.shape[1]
        before = 2 if self.causal else 1
        xp = F.pad(x.to(dt).float(), (0, 0, 0, 0, 0, 0, before, 2 - before))
        out = sum(xp[:, j:j + f] * w[:, j] for j in range(3))  # fp32 accumulation
        return out.to(dt) + conv.bias.to(dt) + x


# --- token-shift feedforward ----------------------------------------------------------------

class TimeTokenShift(nn.Module):
    """Shift the second half of the channels one frame forward (zeros at the
    first frame); images (4-D) pass through."""

    def forward(self, x):
        if x.ndim != 5:
            return x
        keep, shift = x.chunk(2, dim=-1)
        return torch.cat((keep, _shift_frames(shift, 1)), dim=-1)


class ChanFeedForwardVideo(nn.Sequential):
    """ChanLayerNorm -> 1x1 -> GELU -> TimeTokenShift -> ChanLayerNorm -> 1x1,
    no biases (Sequential indices 0, 1, 4, 5 hold the parameters)."""

    def __init__(self, dim, mult=2., time_token_shift=True, dtype=F32):
        hidden_dim = int(dim * mult)
        super().__init__(
            ChanLayerNorm(dim, video=True),
            unit_time(Conv1x1(dim, hidden_dim, bias=False, dtype=dtype)),
            nn.GELU(),
            TimeTokenShift() if time_token_shift else nn.Identity(),
            ChanLayerNorm(hidden_dim, video=True),
            unit_time(Conv1x1(hidden_dim, dim, bias=False, dtype=dtype)),
        )


# --- resnet / transformer for video ---------------------------------------------------------

class BlockVideo(nn.Module):
    """ChanRMSNorm -> (FiLM) -> SiLU -> pseudo-3D conv."""

    def __init__(self, dim, dim_out, norm=True, dtype=F32):
        super().__init__()
        self.norm = ChanRMSNorm(dim) if norm else None
        self.project = PseudoConv3d(dim, dim_out, 3, dtype=dtype)

    def forward(self, x, scale_shift=None, ignore_time=False):
        if exists(self.norm):
            x = self.norm(x, scale_shift=scale_shift, fuse_silu=True)
        else:
            if exists(scale_shift):
                scale, shift = scale_shift
                x = x * (scale + 1) + shift
            x = F.silu(x)
        return self.project(x, ignore_time=ignore_time)


class ResnetBlockVideo(nn.Module):
    """Video resnet block: cross-attention (linear with `linear_attn`) over
    the flattened (f h w) tokens, GlobalContext pooled over all of them.
    With `remat` the block is recomputed in the backward pass."""

    def __init__(self, dim, dim_out, cond_dim=None, time_cond_dim=None, linear_attn=False,
                 use_gca=False, attn_dim_head=64, attn_heads=8, dtype=F32, remat=False):
        super().__init__()
        self.remat = bool(remat)
        self.time_mlp = nn.Sequential(
            nn.SiLU(), Linear(time_cond_dim, dim_out * 2, dtype=dtype),
        ) if exists(time_cond_dim) else None
        self.cross_attn = CrossAttention(
            dim_out, context_dim=cond_dim, dim_head=attn_dim_head, heads=attn_heads,
            linear=linear_attn, dtype=dtype) if exists(cond_dim) else None
        self.block1 = BlockVideo(dim, dim_out, dtype=dtype)
        self.block2 = BlockVideo(dim_out, dim_out, dtype=dtype)
        self.gca = unit_time(GlobalContext(dim_out, dim_out, dtype=dtype)) if use_gca else None
        self.res_conv = unit_time(Conv1x1(dim, dim_out, dtype=dtype)) \
            if dim != dim_out else None

    def forward(self, x, time_emb=None, cond=None, ignore_time=False):
        return recomputed(self._forward, x, time_emb, cond, ignore_time, enabled=self.remat)

    def _forward(self, x, time_emb, cond, ignore_time):
        scale_shift = None
        if exists(self.time_mlp) and exists(time_emb):
            t = self.time_mlp(time_emb)
            scale_shift = t[:, None, None, None, :].chunk(2, dim=-1)

        h = self.block1(x, ignore_time=ignore_time)

        if exists(self.cross_attn):
            if not exists(cond):
                raise ValueError('ResnetBlockVideo with cross-attention needs cond')
            b, f, hh, ww, c = h.shape
            h_flat = h.reshape(b, f * hh * ww, c)
            h_flat = self.cross_attn(h_flat, context=cond) + h_flat
            h = h_flat.reshape(b, f, hh, ww, c)

        h = self.block2(h, scale_shift=scale_shift, ignore_time=ignore_time)

        if exists(self.gca):
            b, f, hh, ww, c = h.shape
            h = h * self.gca(h.reshape(b, f * hh, ww, c))[:, None]

        if exists(self.res_conv):
            x = self.res_conv(x)
        return h + x


class TransformerBlockVideo(nn.Module):
    """Full attention over (f h w) tokens + the token-shift channel FF.
    `generator` is taken, and unused, as the linear block takes it for its
    dropout."""

    def __init__(self, dim, depth=1, heads=8, dim_head=32, ff_mult=2.,
                 ff_time_token_shift=True, context_dim=None, dtype=F32):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.ModuleList([
                Attention(dim, heads=heads, dim_head=dim_head, context_dim=context_dim,
                          dtype=dtype),
                ChanFeedForwardVideo(dim, mult=ff_mult, time_token_shift=ff_time_token_shift,
                                     dtype=dtype),
            ]) for _ in range(depth)])

    def forward(self, x, context=None, generator=None):
        b, f, hh, ww, c = x.shape
        for attn, ff in self.layers:
            tokens = x.reshape(b, f * hh * ww, c)
            tokens = attn(tokens, context=context) + tokens
            x = tokens.reshape(b, f, hh, ww, c)
            x = ff(x) + x
        return x


class LinearAttentionTransformerBlockVideo(nn.Module):
    """Per-frame spatial linear attention (frames folded into the batch, the
    context repeated per frame) + the token-shift channel FF. Parameters
    in lucidrains' video shapes: unit-time convs, (1, C, 1, 1, 1) gains."""

    def __init__(self, dim, depth=1, heads=8, dim_head=32, ff_mult=2.,
                 ff_time_token_shift=True, context_dim=None, dtype=F32):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.ModuleList([
                LinearAttention(dim, heads=heads, dim_head=dim_head, context_dim=context_dim,
                                video=True, dtype=dtype),
                ChanFeedForwardVideo(dim, mult=ff_mult, time_token_shift=ff_time_token_shift,
                                     dtype=dtype),
            ]) for _ in range(depth)])

    def forward(self, x, context=None, generator=None):
        b, f = x.shape[:2]
        ctx = None if context is None else context.repeat_interleave(f, dim=0)
        for attn, ff in self.layers:
            folded, _ = fold_frames(x)
            folded = attn(folded, context=ctx, generator=generator) + folded
            x = unfold_frames(folded, b)
            x = ff(x) + x
        return x


# --- temporal resolution changers -----------------------------------------------------------

class _PointwiseConv1d(nn.Conv1d):
    """A kernel-1 Conv1d (weight (O, I, 1)) applied as a Linear on the channels."""

    def __init__(self, dim_in, dim_out, dtype=F32):
        super().__init__(dim_in, dim_out, 1)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.flatten(1).to(dt), self.bias.to(dt))


class TemporalPixelShuffleUpsample(nn.Module):
    """Pointwise conv c -> c * stride (its init sampled at c and replicated
    over the stride), SiLU, then the extra channels become frames."""

    def __init__(self, dim, dim_out=None, stride=2, dtype=F32):
        super().__init__()
        dim_out = default(dim_out, dim)
        self.stride = stride
        self.conv = _PointwiseConv1d(dim, dim_out * stride, dtype=dtype)
        with torch.no_grad():
            bound = math.sqrt(6.0 / dim)
            w = torch.empty(dim_out, dim, device=self.conv.weight.device).uniform_(-bound, bound)
            self.conv.weight.copy_(w.repeat_interleave(stride, dim=0)[:, :, None])
            self.conv.bias.zero_()

    def forward(self, x):
        out = F.silu(self.conv(x))
        b, f, hh, ww, cr = out.shape
        r = self.stride
        # 'b f h w (c r) -> b (f r) h w c'
        return out.reshape(b, f, hh, ww, cr // r, r).permute(0, 1, 5, 2, 3, 4).reshape(
            b, f * r, hh, ww, cr // r)


class TemporalDownsample(nn.Module):
    """Frames to channels ('b (f p) h w c -> b f h w (c p)'), then a pointwise conv."""

    def __init__(self, dim, dim_out=None, stride=2, dtype=F32):
        super().__init__()
        self.stride = stride
        self.conv = _PointwiseConv1d(dim * stride, default(dim_out, dim), dtype=dtype)

    def forward(self, x):
        b, fp, hh, ww, c = x.shape
        p = self.stride
        x = x.reshape(b, fp // p, p, hh, ww, c).permute(0, 1, 3, 4, 5, 2).reshape(
            b, fp // p, hh, ww, c * p)
        return self.conv(x)


class UpsampleCombinerVideo(nn.Module):
    """Optionally resize + BlockVideo every upsample-stage fmap and concat them."""

    def __init__(self, dim, enabled=False, dim_ins=tuple(), dim_outs=tuple(), dtype=F32):
        super().__init__()
        dim_outs = cast_tuple(dim_outs, len(dim_ins))
        self.enabled = enabled
        self.fmap_convs = nn.ModuleList([
            BlockVideo(dim_in, dim_out, dtype=dtype) for dim_in, dim_out in zip(dim_ins, dim_outs)
        ]) if enabled else nn.ModuleList()
        self.dim_out = dim + (sum(dim_outs) if enabled and len(dim_outs) > 0 else 0)

    def forward(self, x, fmaps=None):
        fmaps = default(fmaps, tuple())
        if not self.enabled or len(fmaps) == 0 or len(self.fmap_convs) == 0:
            return x
        target_size = x.shape[-2]
        outs = [conv(resize_video_to(fmap, target_size))
                for fmap, conv in zip(fmaps, self.fmap_convs)]
        return torch.cat((x, *outs), dim=-1)
