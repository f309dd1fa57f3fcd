"""A plain float32 text-conditional U-Net, the reference that the served
images are judged against.

It follows the U-Net of the Imagen paper's appendix as lucidrains'
imagen-pytorch v2.0.0 builds it (`Unet` with the options of the
`BaseUnet64`, `SRUnet256` and `SRUnet1024` presets): a cross-embed stem,
learned-sinusoidal time conditioning, T5 tokens pooled by a Perceiver
resampler, ResNet blocks with RMS norms, FiLM, cross-attention and a
global-context gate, multi-query transformer blocks with cosine-similarity
attention, space-to-depth downsampling and pixel-shuffle upsampling. The
parameter names and shapes are that `Unet`'s `state_dict` keys, so one set
of weights loads into both. Every activation is NCHW; the forward takes and
returns NHWC images. Options outside those presets raise. Every product goes
through `numerics`, so the same code computes the control in float8.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from port_bench.reference import numerics as nx

SUPPORTED = dict(
    num_time_tokens=2, learned_sinu_pos_emb_dim=16, init_cross_embed=True,
    attn_pool_text=True, use_global_context_attn=True, scale_skip_connection=True,
    final_resnet_block=True, final_conv_kernel_size=3, pixel_shuffle_upsample=True,
    combine_upsample_fmaps=False, attend_at_middle=True, layer_attns_depth=1,
    layer_mid_attns_depth=1, init_conv_to_final_conv_residual=False, self_cond=False,
    cond_images_channels=0, use_linear_attn=False, use_linear_cross_attn=False,
    cross_embed_downsample=False, layer_attns_add_text_cond=True, cond_dim=None,
    channels=3, channels_out=None, init_dim=None,
)


def per_level(value, n):
    return tuple(value) if isinstance(value, (list, tuple)) else (value,) * n


def l2norm(t, dim=-1):
    return t / t.norm(dim=dim, keepdim=True).clamp(min=1e-12)


def layer_norm(x, g, b=None, dim=-1):
    """LayerNorm over `dim` with eps 1e-5, gain `g` and optional bias."""
    mean = x.mean(dim=dim, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=dim, keepdim=True)
    shape = [1] * x.ndim
    shape[dim] = -1
    y = (x - mean) / torch.sqrt(var + 1e-5) * g.reshape(shape)
    return y if b is None else y + b.reshape(shape)


def to_tokens(x):
    """NCHW -> (b, h*w, c)."""
    return x.flatten(2).transpose(1, 2)


def from_tokens(t, h, w):
    return t.transpose(1, 2).reshape(t.shape[0], -1, h, w)


def attend(q, k, v, heads_k):
    """Softmax(q k^T * 8) v; q (b, h, i, d), k and v (b, j, d) shared by the
    heads (`heads_k` False) or (b, h, j, d)."""
    spec = ('bhid,bhjd->bhij', 'bhij,bhjd->bhid') if heads_k else (
        'bhid,bjd->bhij', 'bhij,bjd->bhid')
    attn = torch.softmax(nx.einsum(spec[0], q, k) * 8., dim=-1)
    return nx.einsum(spec[1], attn, v)


def split_heads(t, h):
    b, n, hd = t.shape
    return t.reshape(b, n, h, hd // h).transpose(1, 2)


def merge_heads(t):
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d)


class Lin(nn.Module):
    """Weight (out, in) and optional bias."""

    def __init__(self, dim_in, dim_out, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim_out, dim_in))
        self.bias = nn.Parameter(torch.empty(dim_out)) if bias else None

    def forward(self, x):
        return nx.linear(x, self.weight, self.bias)


class Conv(nn.Module):
    """Weight (out, in, k, k), bias, SAME padding for odd k."""

    def __init__(self, dim_in, dim_out, k, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim_out, dim_in, k, k))
        self.bias = nn.Parameter(torch.empty(dim_out)) if bias else None
        self.pad = k // 2

    def forward(self, x):
        return nx.conv2d(x, self.weight, self.bias, padding=self.pad)


class Gain(nn.Module):
    """Bias-free LayerNorm over the last axis (parameter 'g')."""

    def __init__(self, dim):
        super().__init__()
        self.g = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        return layer_norm(x, self.g)


class AffineNorm(nn.Module):
    """LayerNorm over the last axis with weight and bias."""

    def __init__(self, dim):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias)


class SiLU(nn.Module):
    def forward(self, x):
        return F.silu(x)


class FeedForward(nn.Sequential):
    """LayerNorm, Linear, GELU, LayerNorm, Linear; no biases."""

    def __init__(self, dim, mult):
        hidden = int(dim * mult)
        super().__init__(Gain(dim), Lin(dim, hidden, bias=False), nn.GELU(), Gain(hidden),
                         Lin(hidden, dim, bias=False))


class SinusoidalTime(nn.Module):
    """Random-fourier features of t with t itself first."""

    def __init__(self, dim):
        super().__init__()
        self.weights = nn.Parameter(torch.empty(dim // 2))

    def forward(self, t):
        t = t[:, None].float()
        freqs = t * self.weights[None] * 2 * math.pi
        return torch.cat((t, freqs.sin(), freqs.cos()), dim=-1)


class ToTokens(nn.Module):
    def __init__(self, n):
        super().__init__()
        self.n = n

    def forward(self, x):
        return x.reshape(x.shape[0], self.n, -1)


class CrossEmbed(nn.Module):
    """Stride-1 convs of several sizes, channels halved per scale, concatenated."""

    def __init__(self, dim_in, kernel_sizes, dim_out):
        super().__init__()
        kernel_sizes = sorted(kernel_sizes)
        dims = [int(dim_out / 2 ** i) for i in range(1, len(kernel_sizes))]
        dims.append(dim_out - sum(dims))
        self.convs = nn.ModuleList([Conv(dim_in, d, k) for k, d in zip(kernel_sizes, dims)])

    def forward(self, x):
        return torch.cat([conv(x) for conv in self.convs], dim=1)


class PerceiverAttention(nn.Module):
    def __init__(self, dim, dim_head, heads):
        super().__init__()
        self.heads = heads
        self.norm = AffineNorm(dim)
        self.norm_latents = AffineNorm(dim)
        self.to_q = Lin(dim, dim_head * heads, bias=False)
        self.to_kv = Lin(dim, dim_head * heads * 2, bias=False)
        self.q_scale = nn.Parameter(torch.empty(dim_head))
        self.k_scale = nn.Parameter(torch.empty(dim_head))
        self.to_out = nn.Sequential(Lin(dim_head * heads, dim, bias=False), AffineNorm(dim))

    def forward(self, x, latents):
        x, latents = self.norm(x), self.norm_latents(latents)
        q = split_heads(self.to_q(latents), self.heads)
        k, v = (split_heads(t, self.heads)
                for t in self.to_kv(torch.cat((x, latents), dim=1)).chunk(2, dim=-1))
        q, k = l2norm(q) * self.q_scale, l2norm(k) * self.k_scale
        return self.to_out(merge_heads(attend(q, k, v, heads_k=True)))


class PerceiverResampler(nn.Module):
    """32 learned latents and 4 from the mean-pooled text, two layers of
    attention over (text ++ latents) and a feedforward of width 4x."""

    def __init__(self, dim, dim_head, heads, num_latents, depth=2, mean_pooled=4,
                 max_seq_len=512):
        super().__init__()
        self.mean_pooled = mean_pooled
        self.pos_emb = nn.Embedding(max_seq_len, dim)
        self.latents = nn.Parameter(torch.empty(num_latents, dim))
        self.to_latents_from_mean_pooled_seq = nn.Sequential(Gain(dim),
                                                             Lin(dim, dim * mean_pooled))
        self.layers = nn.ModuleList([
            nn.ModuleList([PerceiverAttention(dim, dim_head, heads), FeedForward(dim, 4.)])
            for _ in range(depth)])

    def forward(self, x):
        b, n, d = x.shape
        x_pos = x + self.pos_emb.weight[:n]
        pooled = self.to_latents_from_mean_pooled_seq(x.mean(dim=1))
        latents = torch.cat((pooled.reshape(b, self.mean_pooled, d),
                             self.latents.expand(b, -1, -1)), dim=1)
        for attn, ff in self.layers:
            latents = attn(x_pos, latents) + latents
            latents = ff(latents) + latents
        return latents


class CrossAttention(nn.Module):
    """Multi-head attention of image tokens over the conditioning tokens,
    with a learned null key and value, cosine similarity and learned scales."""

    def __init__(self, dim, context_dim, dim_head=64, heads=8):
        super().__init__()
        self.heads = heads
        self.norm = Gain(dim)
        self.null_kv = nn.Parameter(torch.empty(2, dim_head))
        self.to_q = Lin(dim, dim_head * heads, bias=False)
        self.to_kv = Lin(context_dim, dim_head * heads * 2, bias=False)
        self.q_scale = nn.Parameter(torch.empty(dim_head))
        self.k_scale = nn.Parameter(torch.empty(dim_head))
        self.to_out = nn.Sequential(Lin(dim_head * heads, dim, bias=False), Gain(dim))

    def forward(self, x, context):
        b, h = x.shape[0], self.heads
        q = split_heads(self.to_q(self.norm(x)), h)
        k, v = (split_heads(t, h) for t in self.to_kv(context).chunk(2, dim=-1))
        null_k, null_v = (n.expand(b, h, 1, -1) for n in self.null_kv)
        k, v = torch.cat((null_k, k), dim=2), torch.cat((null_v, v), dim=2)
        q, k = l2norm(q) * self.q_scale, l2norm(k) * self.k_scale
        return self.to_out(merge_heads(attend(q, k, v, heads_k=True)))


class Attention(nn.Module):
    """Multi-query self-attention: one key and value head for all query
    heads, a learned null key and value, and the context's keys and values
    (through a LayerNorm and a projection) in front."""

    def __init__(self, dim, dim_head, heads, context_dim=None):
        super().__init__()
        self.heads = heads
        self.norm = Gain(dim)
        self.null_kv = nn.Parameter(torch.empty(2, dim_head))
        self.to_q = Lin(dim, dim_head * heads, bias=False)
        self.to_kv = Lin(dim, dim_head * 2, bias=False)
        self.q_scale = nn.Parameter(torch.empty(dim_head))
        self.k_scale = nn.Parameter(torch.empty(dim_head))
        self.to_context = nn.Sequential(AffineNorm(context_dim), Lin(context_dim, dim_head * 2)) \
            if context_dim is not None else None
        self.to_out = nn.Sequential(Lin(dim_head * heads, dim, bias=False), Gain(dim))

    def forward(self, x, context=None):
        b = x.shape[0]
        x = self.norm(x)
        q = split_heads(self.to_q(x), self.heads)
        k, v = self.to_kv(x).chunk(2, dim=-1)
        k = torch.cat((self.null_kv[0].expand(b, 1, -1), k), dim=1)
        v = torch.cat((self.null_kv[1].expand(b, 1, -1), v), dim=1)
        if context is not None:
            ck, cv = self.to_context(context).chunk(2, dim=-1)
            k, v = torch.cat((ck, k), dim=1), torch.cat((cv, v), dim=1)
        q, k = l2norm(q) * self.q_scale, l2norm(k) * self.k_scale
        return self.to_out(merge_heads(attend(q, k, v, heads_k=False)))


class TransformerBlock(nn.Module):
    def __init__(self, dim, dim_head, heads, ff_mult, context_dim=None, depth=1):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.ModuleList([Attention(dim, dim_head, heads, context_dim),
                           FeedForward(dim, ff_mult)]) for _ in range(depth)])

    def forward(self, x, context=None):
        h, w = x.shape[-2:]
        t = to_tokens(x)
        for attn, ff in self.layers:
            t = attn(t, context) + t
            t = ff(t) + t
        return from_tokens(t, h, w)


class ChanRMSNorm(nn.Module):
    """x / ||x|| over the channels, times sqrt(C) and a gain 'gamma' (C, 1, 1)."""

    def __init__(self, dim):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim, 1, 1))

    def forward(self, x):
        return l2norm(x, dim=1) * x.shape[1] ** 0.5 * self.gamma


class Block(nn.Module):
    """RMS norm, FiLM, SiLU, 3x3 conv."""

    def __init__(self, dim, dim_out):
        super().__init__()
        self.norm = ChanRMSNorm(dim)
        self.project = Conv(dim, dim_out, 3)

    def forward(self, x, scale_shift=None):
        x = self.norm(x)
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1) + shift
        return self.project(F.silu(x))


class GlobalContext(nn.Module):
    """A softmax-pooled summary of the fmap, through a bottleneck, as a sigmoid gate."""

    def __init__(self, dim_in, dim_out):
        super().__init__()
        hidden = max(3, dim_out // 2)
        self.to_k = Conv(dim_in, 1, 1)
        self.net = nn.Sequential(Conv(dim_in, hidden, 1), SiLU(), Conv(hidden, dim_out, 1),
                                 nn.Sigmoid())

    def forward(self, x):
        attn = torch.softmax(self.to_k(x).flatten(2), dim=-1)          # (b, 1, n)
        pooled = nx.einsum('bin,bcn->bci', attn, x.flatten(2))         # (b, c, 1)
        return self.net(pooled[..., None])


class ResnetBlock(nn.Module):
    def __init__(self, dim, dim_out, time_cond_dim, cond_dim=None, use_gca=False,
                 dim_head=64, heads=8):
        super().__init__()
        self.time_mlp = nn.Sequential(SiLU(), Lin(time_cond_dim, dim_out * 2))
        self.cross_attn = CrossAttention(dim_out, cond_dim, dim_head, heads) \
            if cond_dim is not None else None
        self.block1 = Block(dim, dim_out)
        self.block2 = Block(dim_out, dim_out)
        self.gca = GlobalContext(dim_out, dim_out) if use_gca else None
        self.res_conv = Conv(dim, dim_out, 1) if dim != dim_out else None

    def forward(self, x, t, cond=None):
        h = self.block1(x)
        if self.cross_attn is not None:
            hh, ww = h.shape[-2:]
            tok = to_tokens(h)
            h = from_tokens(self.cross_attn(tok, cond) + tok, hh, ww)
        scale_shift = self.time_mlp(t)[:, :, None, None].chunk(2, dim=1)
        h = self.block2(h, scale_shift)
        if self.gca is not None:
            h = h * self.gca(h)
        return h + (x if self.res_conv is None else self.res_conv(x))


class Downsample(nn.Sequential):
    """Space-to-depth (channel order c, s1, s2), then a 1x1 conv."""

    def __init__(self, dim, dim_out):
        super().__init__(nn.PixelUnshuffle(2), Conv(dim * 4, dim_out, 1))


class Parallel(nn.Module):
    def __init__(self, *fns):
        super().__init__()
        self.fns = nn.ModuleList(fns)

    def forward(self, x):
        return sum(fn(x) for fn in self.fns)


class PixelShuffleUpsample(nn.Module):
    def __init__(self, dim, dim_out):
        super().__init__()
        self.net = nn.Sequential(Conv(dim, dim_out * 4, 1), SiLU(), nn.PixelShuffle(2))

    def forward(self, x):
        return self.net(x)


class Unet(nn.Module):
    """The U-Net of the presets; keyword names are lucidrains' `Unet`'s."""

    def __init__(self, *, dim, dim_mults, num_resnet_blocks, layer_attns, layer_cross_attns,
                 attn_heads, attn_dim_head, ff_mult, memory_efficient, text_embed_dim,
                 max_text_len, lowres_cond, init_cross_embed_kernel_sizes=(3, 7, 15),
                 attn_pool_num_latents=32, **options):
        super().__init__()
        for key, value in options.items():
            if key not in SUPPORTED or SUPPORTED[key] != value:
                raise ValueError(f'the reference U-Net does not implement {key}={value!r}')
        n = len(dim_mults)
        channels = 3
        self.lowres_cond = lowres_cond
        self.max_text_len = max_text_len
        cond_dim = dim
        time_cond_dim = dim * 4 * (2 if lowres_cond else 1)
        num_resnet_blocks = per_level(num_resnet_blocks, n)
        layer_attns = per_level(layer_attns, n)
        layer_cross_attns = per_level(layer_cross_attns, n)
        self.skip_scale = 2 ** -0.5

        self.init_conv = CrossEmbed(channels * (2 if lowres_cond else 1),
                                    init_cross_embed_kernel_sizes, dim)

        def time_heads():
            return (nn.Sequential(SinusoidalTime(16), Lin(17, time_cond_dim), SiLU()),
                    nn.Sequential(Lin(time_cond_dim, time_cond_dim)),
                    nn.Sequential(Lin(time_cond_dim, cond_dim * 2), ToTokens(2)))

        self.to_time_hiddens, self.to_time_cond, self.to_time_tokens = time_heads()
        if lowres_cond:
            (self.to_lowres_time_hiddens, self.to_lowres_time_cond,
             self.to_lowres_time_tokens) = time_heads()
        self.norm_cond = AffineNorm(cond_dim)
        self.text_to_cond = Lin(text_embed_dim, cond_dim)
        self.attn_pool = PerceiverResampler(cond_dim, attn_dim_head, attn_heads,
                                            attn_pool_num_latents)
        self.null_text_embed = nn.Parameter(torch.empty(1, max_text_len, cond_dim))
        self.null_text_hidden = nn.Parameter(torch.empty(1, time_cond_dim))
        self.to_text_non_attn_cond = nn.Sequential(
            AffineNorm(cond_dim), Lin(cond_dim, time_cond_dim), SiLU(),
            Lin(time_cond_dim, time_cond_dim))

        head = dict(dim_head=attn_dim_head, heads=attn_heads)
        self.init_resnet_block = ResnetBlock(dim, dim, time_cond_dim, use_gca=True, **head) \
            if memory_efficient else None

        dims = [dim, *(dim * m for m in dim_mults)]
        in_out = list(zip(dims[:-1], dims[1:]))
        self.downs = nn.ModuleList()
        for i, (d_in, d_out) in enumerate(in_out):
            last = i == n - 1
            cur = d_out if memory_efficient else d_in
            cross = cond_dim if layer_cross_attns[i] else None
            if memory_efficient:
                post = None
            elif not last:
                post = Downsample(cur, d_out)
            else:
                post = Parallel(Conv(d_in, d_out, 3), Conv(d_in, d_out, 1))
            self.downs.append(nn.ModuleList([
                Downsample(d_in, d_out) if memory_efficient else None,
                ResnetBlock(cur, cur, time_cond_dim, cond_dim=cross, **head),
                nn.ModuleList([ResnetBlock(cur, cur, time_cond_dim, use_gca=True, **head)
                               for _ in range(num_resnet_blocks[i])]),
                TransformerBlock(cur, attn_dim_head, attn_heads, ff_mult, cond_dim)
                if layer_attns[i] else None,
                post,
            ]))

        mid = dims[-1]
        self.mid_block1 = ResnetBlock(mid, mid, time_cond_dim, cond_dim=cond_dim)
        self.mid_attn = TransformerBlock(mid, attn_dim_head, attn_heads, ff_mult)
        self.mid_block2 = ResnetBlock(mid, mid, time_cond_dim, cond_dim=cond_dim)

        self.ups = nn.ModuleList()
        for i, (d_in, d_out) in enumerate(reversed(in_out)):
            level = n - 1 - i
            skip = d_out if memory_efficient else d_in
            cross = cond_dim if layer_cross_attns[level] else None
            self.ups.append(nn.ModuleList([
                ResnetBlock(d_out + skip, d_out, time_cond_dim, cond_dim=cross, **head),
                nn.ModuleList([ResnetBlock(d_out + skip, d_out, time_cond_dim, use_gca=True,
                                           **head)
                               for _ in range(num_resnet_blocks[level])]),
                TransformerBlock(d_out, attn_dim_head, attn_heads, ff_mult, cond_dim)
                if layer_attns[level] else None,
                PixelShuffleUpsample(d_out, d_in) if (i < n - 1 or memory_efficient) else None,
            ]))

        self.final_res_block = ResnetBlock(dim, dim, time_cond_dim, use_gca=True, **head)
        self.final_conv = Conv(dim + (channels if lowres_cond else 0), channels, 3)

    def _time(self, t, hiddens, cond, tokens):
        h = hiddens(t)
        return cond(h), tokens(h)

    def condition(self, time, text_embeds, text_mask, drop_text, lowres_noise_times=None):
        """The FiLM vector (b, time_cond_dim) and the normed conditioning tokens."""
        t, time_tokens = self._time(time, self.to_time_hiddens, self.to_time_cond,
                                    self.to_time_tokens)
        if self.lowres_cond:
            lt, ltok = self._time(lowres_noise_times, self.to_lowres_time_hiddens,
                                  self.to_lowres_time_cond, self.to_lowres_time_tokens)
            t = t + lt
            time_tokens = torch.cat((time_tokens, ltok), dim=1)
        keep = ~drop_text
        tokens = self.text_to_cond(text_embeds.float())[:, :self.max_text_len]
        mask = text_mask[:, :self.max_text_len]
        pad = self.max_text_len - tokens.shape[1]
        if pad > 0:
            tokens = F.pad(tokens, (0, 0, 0, pad))
            mask = F.pad(mask, (0, pad), value=False)
        tokens = torch.where((mask & keep[:, None])[..., None], tokens, self.null_text_embed)
        tokens = self.attn_pool(tokens)
        hidden = self.to_text_non_attn_cond(tokens.mean(dim=1))
        t = t + torch.where(keep[:, None], hidden, self.null_text_hidden)
        return t, self.norm_cond(torch.cat((time_tokens, tokens), dim=1))

    def forward(self, x, time, *, text_embeds, text_mask, drop_text, lowres_cond_img=None,
                lowres_noise_times=None):
        """x (b, H, W, 3) NHWC; returns the predicted noise, NHWC. `drop_text`
        (b,) bool replaces the text by the learned null embeddings."""
        x = x.float().permute(0, 3, 1, 2)
        lowres = None if lowres_cond_img is None else lowres_cond_img.float().permute(0, 3, 1, 2)
        if lowres is not None:
            x = torch.cat((x, lowres), dim=1)
        x = self.init_conv(x)
        t, c = self.condition(time, text_embeds, text_mask, drop_text, lowres_noise_times)
        if self.init_resnet_block is not None:
            x = self.init_resnet_block(x, t)

        hiddens = []
        for pre, init_block, blocks, attn, post in self.downs:
            if pre is not None:
                x = pre(x)
            x = init_block(x, t, c)
            for block in blocks:
                x = block(x, t)
                hiddens.append(x)
            if attn is not None:
                x = attn(x, c)
            hiddens.append(x)
            if post is not None:
                x = post(x)

        x = self.mid_block1(x, t, c)
        x = self.mid_attn(x)
        x = self.mid_block2(x, t, c)

        for init_block, blocks, attn, up in self.ups:
            x = init_block(torch.cat((x, hiddens.pop() * self.skip_scale), dim=1), t, c)
            for block in blocks:
                x = block(torch.cat((x, hiddens.pop() * self.skip_scale), dim=1), t)
            if attn is not None:
                x = attn(x, c)
            if up is not None:
                x = up(x)

        x = self.final_res_block(x, t)
        if lowres is not None:
            x = torch.cat((x, lowres), dim=1)
        return self.final_conv(x).permute(0, 2, 3, 1)
