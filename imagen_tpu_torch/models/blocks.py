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
- Dropout (only `LinearAttention` has any) draws its keep masks from an
  explicit `torch.Generator` in train mode and none in eval mode; a caller
  may draw them beforehand (`dropout_masks`) and pass them in, so that a
  recomputed block applies the same masks.
- Remat (`remat=True` or `'save_convs'` on the blocks that take it) is
  `torch.utils.checkpoint`, non-reentrant, taken only while a gradient is
  being recorded (`recomputed`); `'save_convs'` keeps a conv's output and
  recomputes only what comes before it (`keeps_output`), as JAX's
  `save_only_these_names` policy does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from imagen_tpu_torch.ops.attention import (
    kernelized_linear_attention,
    multihead_attention,
    multiquery_attention_packed,
)
from imagen_tpu_torch.ops.conv2d import conv3x3
from imagen_tpu_torch.ops.fused_norm import (
    chan_rms_norm,
    feedforward,
    layernorm,
    ln_eps,
    pack_ff_weights,
)
from imagen_tpu_torch.ops.stem_conv import cross_embed, pack_stem_weights
from imagen_tpu_torch.ops.tensor_utils import l2norm, masked_mean, resize_image_to
from imagen_tpu_torch.parallel.rows import rows_of
from imagen_tpu_torch.utils.helpers import cast_tuple, default, exists

F32 = torch.float32


def remat_mode(remat):
    """False, True or 'save_convs', as the JAX U-Nets read their `remat`
    field: 'save_convs' by name, any other true value as True."""
    if remat == 'save_convs':
        return remat
    return bool(remat)


def recomputed(fn, *args, enabled=True):
    """`fn(*args)` with its activations dropped after the forward and
    recomputed in the backward pass (`torch.utils.checkpoint`, non-reentrant)
    while a gradient is being recorded and `enabled`; a plain call otherwise.
    Early stop is off, so the recompute runs every op of `fn` again: each
    kernel wrapper inside launches, and each forward hook fires, a second
    time."""
    if not (enabled and torch.is_grad_enabled()):
        return fn(*args)
    with torch_checkpoint.set_checkpoint_early_stop(False):
        return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False)


def keeps_output(prologue, layer, *args):
    """`layer(prologue(*args))`, keeping for the backward pass only `args`
    and the layer's output, as JAX's `save_only_these_names` policy does for
    a named layer output. What the prologue saves, and the layer's input,
    which the layer's backward reads, are dropped; the backward's first
    request for any of them runs the prologue once more, with a gradient
    recorded as in the forward so that it saves the same tensors in the
    same order, and serves them all. The layer never runs again. A plain
    call while no gradient is recorded."""
    if not torch.is_grad_enabled():
        return layer(prologue(*args))
    rebuilt = []

    def rebuild():
        # detached, so that the rebuilt graph, whose hooks reach `rebuilt`,
        # is not kept alive from it
        if not rebuilt:
            with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
                    lambda t: rebuilt.append(t.detach()), lambda _: None):
                out = prologue(*_detached(args))
            if len(rebuilt) != saved:
                raise RuntimeError(f'the prologue saved {len(rebuilt)} tensors when rebuilt, '
                                   f'{saved} in the forward')
            rebuilt.append(out.detach())
        return rebuilt

    saved = 0

    def pack_prologue(_):
        nonlocal saved
        saved += 1
        return saved - 1

    with torch.autograd.graph.saved_tensors_hooks(pack_prologue, lambda i: rebuild()[i]):
        p = prologue(*args)
    ptr = p.untyped_storage().data_ptr()

    def pack_layer(t):
        # the layer's input or a view of it: keep where it lies, not its data
        if t.untyped_storage().data_ptr() == ptr:
            return t.size(), t.stride(), t.storage_offset()
        return t

    def unpack_layer(kept):
        if isinstance(kept, torch.Tensor):
            return kept
        return rebuild()[-1].as_strided(*kept)

    with torch.autograd.graph.saved_tensors_hooks(pack_layer, unpack_layer):
        return layer(p)


def _detached(a):
    """`a`'s tensors detached, each as ready for a gradient as before."""
    if isinstance(a, torch.Tensor):
        return a.detach().requires_grad_(a.requires_grad)
    if isinstance(a, (tuple, list)):
        return type(a)(_detached(x) for x in a)
    return a


def unit_time(module):
    """Give every 2D conv in `module` the weight of lucidrains' video `Conv2d`,
    an nn.Conv3d with a unit time kernel: (O, I, kh, kw) -> (O, I, 1, kh, kw).
    `Conv1x1`, `Conv2d` and `DepthwiseConv3x3` compute the same with either
    shape."""
    for m in module.modules():
        if isinstance(m, (Conv1x1, Conv2d, DepthwiseConv3x3)) and m.weight.ndim == 4:
            m.weight = nn.Parameter(m.weight.detach()[:, :, None])
    return module


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
    video U-Net holds it (`unit_time`)."""

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
    """3x3 SAME conv: the conv kernel or F.conv2d, as `ops.conv2d.conv3x3`
    routes the call."""

    def __init__(self, dim_in, dim_out, dtype=F32):
        super().__init__(dim_in, dim_out, 3, padding=1, dtype=dtype)

    def forward(self, x):
        x = x.to(self.compute_dtype)
        return conv3x3(x, self.weight, self.bias, lambda: Conv2d.forward(self, x))


class DepthwiseConv3x3(nn.Conv2d):
    """3x3 SAME depthwise conv without bias on NHWC (weight (C, 1, 3, 3), or
    a unit-time video weight (C, 1, 1, 3, 3)); cuDNN's grouped conv."""

    def __init__(self, dim, dtype=F32):
        super().__init__(dim, dim, 3, padding=1, groups=dim, bias=False)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        w = self.weight.reshape(self.out_channels, 1, 3, 3).to(dt)
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), w, None, 1, 1, 1, self.groups)
        return y.permute(0, 2, 3, 1)


# --- norms ------------------------------------------------------------------------------

class LayerNorm(nn.Module):
    """Bias-free LayerNorm (gain 'g'); eps 1e-5 in fp32, 1e-3 in half."""

    def __init__(self, dim, stable=False):
        super().__init__()
        self.stable = stable
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        if self.stable:
            x = x / x.amax(dim=-1, keepdim=True).detach()
        return layernorm(x, self.g, ln_eps(x.dtype))


class ChanLayerNorm(LayerNorm):
    """`LayerNorm` over NHWC's trailing axis, its gain held as lucidrains'
    ChanLayerNorm's (1, C, 1, 1), or (1, C, 1, 1, 1) with `video`."""

    def __init__(self, dim, video=False):
        super().__init__(dim)
        self.g = nn.Parameter(torch.ones(1, dim, 1, 1, *((1,) if video else ())))

    def forward(self, x):
        return layernorm(x, self.g.reshape(-1), ln_eps(x.dtype))


class ChanRMSNorm(nn.Module):
    """Channel RMSNorm on NHWC's trailing axis, with the FiLM and SiLU that
    follow it in Block applied in the same call (`ops.fused_norm.chan_rms_norm`).

    With `fused`, a call with the SiLU whose shape the gate admits runs the
    whole norm -> FiLM -> SiLU chain as kernel 8, in fp32 with one rounding
    at the end: the JAX `IMAGEN_TPU_FUSED_FILM=1` route. The parameter is the
    same either way."""

    def __init__(self, dim, fused=False):
        super().__init__()
        self.fused = fused
        self.gamma = nn.Parameter(torch.ones(dim, 1, 1))

    def forward(self, x, scale_shift=None, fuse_silu=False):
        return chan_rms_norm(x, self.gamma, scale_shift, silu=fuse_silu, fused=self.fused)


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

    Where the gate admits the shape the whole chain runs as kernel 10
    (`ops.fused_norm.feedforward`); the parameters are the same either way.
    Without a gradient the kernel's bf16 weights are kept until a weight
    changes or the module moves. With `chan` the parameters are lucidrains'
    ChanFeedForward's, gains (1, C, 1, 1) and 1x1 conv weights (O, I, 1, 1):
    on NHWC the same chain and route, as the JAX package's
    `ChanFeedForward = FeedForward`."""

    def __init__(self, dim, mult=2., dtype=F32, chan=False):
        hidden_dim = int(dim * mult)
        if chan:
            norm, proj = ChanLayerNorm, (lambda i, o: Conv1x1(i, o, bias=False, dtype=dtype))
        else:
            norm, proj = LayerNorm, (lambda i, o: Linear(i, o, bias=False, dtype=dtype))
        super().__init__(norm(dim), proj(dim, hidden_dim), nn.GELU(), norm(hidden_dim),
                         proj(hidden_dim, dim))
        self.dim, self.hidden_dim = dim, hidden_dim
        self.compute_dtype = dtype

    def _weights(self):
        """The gains as vectors and the weights as (out, in) matrices (views
        of the parameters): (g0, w0, g1, w1)."""
        return (self[0].g.reshape(-1), self[1].weight.flatten(1), self[3].g.reshape(-1),
                self[4].weight.flatten(1))

    def _packed_weights(self):
        """`pack_ff_weights` of the two weights, kept (`KeepsPacked`)."""
        return self.kept((self[1].weight, self[4].weight),
                         lambda: pack_ff_weights(*self._weights()[1::2]))

    def forward(self, x):
        x = x.to(self.compute_dtype)
        return feedforward(x, self.hidden_dim, self._weights, packed=self._packed_weights,
                           plain=lambda: nn.Sequential.forward(self, x))


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


def _fold_heads(t, heads):
    """'b n (h d) -> (b h) n d'."""
    b, n, hd = t.shape
    return _split_heads(t, heads).reshape(b * heads, n, hd // heads)


def _unfold_heads(t, heads):
    """'(b h) n d -> b n (h d)'."""
    bh, n, d = t.shape
    return _merge_heads(t.reshape(bh // heads, heads, n, d))


class CrossAttention(nn.Module):
    """Multi-head cross-attention over conditioning tokens: full cosine-sim
    attention, or with `linear` the kernelized linear attention of the JAX
    module's linear branch (heads folded into the batch, the null k/v
    prepended, masked keys at -max and masked values at 0). The linear
    branch has no q_scale or k_scale, as the JAX module allocates none."""

    def __init__(self, dim, context_dim=None, dim_head=64, heads=8, norm_context=False,
                 scale=8., linear=False, dtype=F32):
        super().__init__()
        context_dim = default(context_dim, dim)
        inner_dim = dim_head * heads
        self.heads, self.scale, self.linear = heads, scale, linear
        self.norm = LayerNorm(dim)
        self.norm_context = LayerNorm(context_dim) if norm_context else None
        self.null_kv = nn.Parameter(torch.randn(2, dim_head))
        self.to_q = Linear(dim, inner_dim, bias=False, dtype=dtype)
        self.to_kv = Linear(context_dim, inner_dim * 2, bias=False, dtype=dtype)
        if not linear:
            self.q_scale = nn.Parameter(torch.ones(dim_head))
            self.k_scale = nn.Parameter(torch.ones(dim_head))
        self.to_out = nn.Sequential(Linear(inner_dim, dim, bias=False, dtype=dtype),
                                    LayerNorm(dim))

    def forward(self, x, context, mask=None):
        b = x.shape[0]
        if exists(self.norm_context):
            context = self.norm_context(context)
        x = self.norm(x)
        q = self.to_q(x)
        k, v = self.to_kv(context).chunk(2, dim=-1)
        if self.linear:
            return self.to_out(self._linear(q, k, v, mask))

        q, k, v = (_split_heads(t, self.heads) for t in (q, k, v))
        nk = self.null_kv[0].to(k.dtype).expand(b, self.heads, 1, -1)
        nv = self.null_kv[1].to(v.dtype).expand(b, self.heads, 1, -1)
        k = torch.cat((nk, k), dim=-2)
        v = torch.cat((nv, v), dim=-2)

        q = l2norm(q) * self.q_scale.to(q.dtype)
        k = l2norm(k) * self.k_scale.to(k.dtype)

        out = multihead_attention(q, k, v, scale=self.scale, mask=mask, null_tokens=1)
        return self.to_out(_merge_heads(out))

    def _linear(self, q, k, v, mask):
        h = self.heads
        q, k, v = (_fold_heads(t, h) for t in (q, k, v))
        bh = q.shape[0]
        k = torch.cat((self.null_kv[0].to(k.dtype).expand(bh, 1, -1), k), dim=-2)
        v = torch.cat((self.null_kv[1].to(v.dtype).expand(bh, 1, -1), v), dim=-2)
        if exists(mask):
            keep = F.pad(mask, (1, 0), value=True).repeat_interleave(h, dim=0)[..., None]
            k = k.masked_fill(~keep, -torch.finfo(k.dtype).max)
            v = v.masked_fill(~keep, 0.)
        out = kernelized_linear_attention(q, k, v, scale=self.scale)
        return _unfold_heads(out, h)


class KeepMaskDropout(nn.Module):
    """Dropout whose keep mask the caller draws: x / (1 - p) where `keep`
    holds and 0 elsewhere, flax's `nn.Dropout`; x itself without a mask."""

    def __init__(self, p):
        super().__init__()
        self.p = p

    def forward(self, x, keep=None):
        if keep is None:
            return x
        return torch.where(keep, x / (1 - self.p), torch.zeros((), dtype=x.dtype, device=x.device))


class LinearAttention(nn.Module):
    """Spatial linear attention on NHWC fmaps: ChanLayerNorm; q, k and v each
    Dropout(0.05) -> 1x1 projection -> depthwise 3x3 conv; context tokens,
    through a LayerNorm with bias and `to_context`, appended to k and v; the
    kernelized attention; SiLU; `to_out` with its ChanLayerNorm.

    In train mode the dropout masks come from `generator`, or are given as
    `masks` (from `dropout_masks`); eval mode draws none. With `video` the
    parameters take lucidrains' video shapes (unit-time convs, 5-D gains)."""

    def __init__(self, dim, dim_head=32, heads=8, dropout=0.05, context_dim=None, video=False,
                 dtype=F32):
        super().__init__()
        inner_dim = dim_head * heads
        self.heads, self.dim_head, self.dropout = heads, dim_head, dropout
        self.norm = ChanLayerNorm(dim, video=video)

        def to_qkv():
            return nn.Sequential(KeepMaskDropout(dropout),
                                 Conv1x1(dim, inner_dim, bias=False, dtype=dtype),
                                 DepthwiseConv3x3(inner_dim, dtype=dtype))

        self.to_q, self.to_k, self.to_v = to_qkv(), to_qkv(), to_qkv()
        self.to_context = nn.Sequential(
            TorchLayerNorm(context_dim, dtype=dtype),
            Linear(context_dim, inner_dim * 2, bias=False, dtype=dtype),
        ) if exists(context_dim) else None
        self.to_out = nn.Sequential(Conv1x1(inner_dim, dim, bias=False, dtype=dtype),
                                    ChanLayerNorm(dim, video=video))
        if video:
            unit_time(self)

    def dropout_masks(self, shape, device, generator=None):
        """The keep masks (3, *shape) of the q, k and v inputs of one call
        on an fmap of `shape`, drawn from `generator` in train mode (keep
        rate 1 - dropout); None in eval mode."""
        if not self.training or self.dropout == 0:
            return None
        return rows_of(lambda n: torch.rand((3, n, *shape[1:]), generator=generator,
                                            device=device), shape[0], dim=1) < 1 - self.dropout

    def forward(self, fmap, context=None, masks=None, generator=None):
        b, xx, yy, _ = fmap.shape
        h = self.heads
        fmap = self.norm(fmap)
        if masks is None:
            masks = self.dropout_masks(fmap.shape, fmap.device, generator)

        def project(i, net):
            t = net[0](fmap, None if masks is None else masks[i])
            t = net[2](net[1](t))
            return _fold_heads(t.reshape(b, xx * yy, -1), h)

        q, k, v = (project(i, net) for i, net in enumerate((self.to_q, self.to_k, self.to_v)))
        if exists(context):
            if self.to_context is None:
                raise ValueError('LinearAttention got context but has no context_dim')
            ck, cv = (_fold_heads(t, h) for t in self.to_context(context).chunk(2, dim=-1))
            k = torch.cat((k, ck), dim=-2)
            v = torch.cat((v, cv), dim=-2)

        out = kernelized_linear_attention(q, k, v, scale=self.dim_head ** -0.5)
        out = _unfold_heads(out, h).reshape(b, xx, yy, -1)
        return self.to_out(F.silu(out))


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
        return self.project(self.prologue(x, scale_shift))

    def prologue(self, x, scale_shift=None):
        """Norm, FiLM and SiLU, cast to the conv's compute dtype."""
        if exists(self.norm):
            x = self.norm(x, scale_shift=scale_shift, fuse_silu=True)
        else:
            if exists(scale_shift):
                scale, shift = scale_shift
                x = x * (scale + 1) + shift
            x = F.silu(x)
        return x.to(self.project.compute_dtype)

    def keeping_conv_out(self, x, scale_shift=None):
        """The forward as remat='save_convs' runs it: the conv's output kept,
        the prologue run once more in the backward pass (`keeps_output`)."""
        return keeps_output(self.prologue, self.project, x, scale_shift)


class ResnetBlock(nn.Module):
    """Time-FiLM'd double conv block with optional cross-attention (linear
    with `linear_attn`) and GlobalContext gate.

    `remat=True` recomputes the whole block in the backward pass;
    `'save_convs'` keeps what the JAX block names for its selective policy
    (each Block's 'conv_out', the cross-attention's 'attn_out') and
    recomputes the rest, never the 3x3 convs."""

    def __init__(self, dim, dim_out, cond_dim=None, time_cond_dim=None, linear_attn=False,
                 use_gca=False, attn_dim_head=64, attn_heads=8, dtype=F32, fused_film=False,
                 remat=False):
        super().__init__()
        self.remat = remat_mode(remat)
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
        if exists(self.cross_attn) and not exists(cond):
            raise ValueError('ResnetBlock with cross-attention needs cond')
        if self.remat == 'save_convs':
            return self._keeping_convs(x, time_emb, cond)
        return recomputed(self._forward, x, time_emb, cond, enabled=self.remat)

    def _forward(self, x, time_emb, cond):
        h = self.block1(x)
        if exists(self.cross_attn):
            h = self._cross(h, cond)
        h = self.block2(h, scale_shift=self._scale_shift(time_emb))
        return self._out(h, x)

    def _keeping_convs(self, x, time_emb, cond):
        h = self.block1.keeping_conv_out(x)
        if exists(self.cross_attn):
            h = recomputed(self._cross, h, cond)
        h = self.block2.keeping_conv_out(h, self._scale_shift(time_emb))
        return recomputed(self._out, h, x)

    def _cross(self, h, cond):
        b, hh, ww, c = h.shape
        h_flat = h.reshape(b, hh * ww, c)
        return (self.cross_attn(h_flat, context=cond) + h_flat).reshape(b, hh, ww, c)

    def _scale_shift(self, time_emb):
        if not (exists(self.time_mlp) and exists(time_emb)):
            return None
        t = self.time_mlp(time_emb)
        return t[:, None, None, :].chunk(2, dim=-1)

    def _out(self, h, x):
        if exists(self.gca):
            h = h * self.gca(h)
        if exists(self.res_conv):
            x = self.res_conv(x)
        return h + x


class TransformerBlock(nn.Module):
    """Flatten the fmap to tokens; depth x (multi-query attention + FF) residual
    layers. `remat=True` recomputes the block in the backward pass,
    `'save_convs'` keeps each layer's 'attn_out' and 'ff_out' (the JAX
    names) and recomputes the attention and the FF from them. `generator`
    is taken, and unused, as the linear block takes it for its dropout."""

    def __init__(self, dim, depth=1, heads=8, dim_head=32, ff_mult=2., context_dim=None,
                 dtype=F32, remat=False):
        super().__init__()
        self.remat = remat_mode(remat)
        self.layers = nn.ModuleList([
            nn.ModuleList([
                Attention(dim, heads=heads, dim_head=dim_head, context_dim=context_dim,
                          dtype=dtype),
                FeedForward(dim, mult=ff_mult, dtype=dtype),
            ]) for _ in range(depth)])

    def forward(self, x, context=None, generator=None):
        return recomputed(self._layers, x, context, enabled=self.remat is True)

    def _layers(self, x, context):
        keep = self.remat == 'save_convs'
        b, hh, ww, c = x.shape
        x = x.reshape(b, hh * ww, c)
        for attn, ff in self.layers:
            x = recomputed(_residual_attn, attn, x, context, enabled=keep)
            x = recomputed(_residual, ff, x, enabled=keep)
        return x.reshape(b, hh, ww, -1)


def _residual(fn, x):
    return fn(x) + x


def _residual_attn(attn, x, context):
    return attn(x, context=context) + x


class LinearAttentionTransformerBlock(nn.Module):
    """depth x (LinearAttention + FeedForward(chan=True)) residual layers on
    NHWC fmaps. Any `remat` recomputes the whole block in the backward pass (the
    JAX block names no output to keep); the dropout masks are drawn before
    the recomputed region, so the recompute applies the same ones."""

    def __init__(self, dim, depth=1, heads=8, dim_head=32, ff_mult=2., context_dim=None,
                 dtype=F32, remat=False):
        super().__init__()
        self.remat = remat_mode(remat)
        self.layers = nn.ModuleList([
            nn.ModuleList([
                LinearAttention(dim, heads=heads, dim_head=dim_head, context_dim=context_dim,
                                dtype=dtype),
                FeedForward(dim, mult=ff_mult, dtype=dtype, chan=True),
            ]) for _ in range(depth)])

    def dropout_masks(self, shape, device, generator=None):
        """Each layer's `LinearAttention.dropout_masks` (None in eval mode)."""
        return [attn.dropout_masks(shape, device, generator) for attn, _ in self.layers]

    def forward(self, x, context=None, generator=None):
        masks = self.dropout_masks(x.shape, x.device, generator)
        return recomputed(self._layers, x, context, masks, enabled=bool(self.remat))

    def _layers(self, x, context, masks):
        for (attn, ff), layer_masks in zip(self.layers, masks):
            x = attn(x, context=context, masks=layer_masks) + x
            x = ff(x) + x
        return x


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

    A stride-1 call whose shape the gate admits runs every scale, the
    concatenation and the bias as kernel 14 (`ops.stem_conv.cross_embed`);
    the parameters are the same either way. Without a gradient the kernel's
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

    def _kept_stem_args(self, dt):
        """`_stem_args` with the bias in `dt`, and the packed weights, kept
        (`KeepsPacked`)."""
        def make():
            ws, bias = self._stem_args(dt)
            return ws, bias.to(dt), pack_stem_weights(ws)
        return self.kept(self.parameters(), make)

    def forward(self, x):
        dt = self.convs[0].compute_dtype
        return cross_embed(x, self.kernel_sizes, dt, self.stride, self.parameters(),
                           weights=lambda: self._stem_args(dt),
                           kept=lambda: self._kept_stem_args(dt),
                           plain=lambda: torch.cat([conv(x) for conv in self.convs], dim=-1))


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
        self.dim_out = self.combined_dim(dim, enabled, dim_ins, dim_outs)

    @staticmethod
    def combined_dim(dim, enabled, dim_ins, dim_outs):
        """The channels out: `dim`, plus every upsample fmap's when enabled."""
        dim_outs = cast_tuple(dim_outs, len(dim_ins))
        return dim + (sum(dim_outs) if enabled and len(dim_outs) > 0 else 0)

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
