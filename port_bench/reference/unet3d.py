"""A plain float32 text-conditional video U-Net, the reference that the
served clips are judged against.

It follows the layer equations of lucidrains' imagen-pytorch v2.0.0
`Unet3D` (`imagen_video.py`), which takes the pseudo-3D U-Net of Ho et al.
2022 (arXiv:2204.03458) but attends over all (f h w) tokens where that
paper attends within each frame, and adds the temporal conv and PEG that
Imagen Video (arXiv:2210.02303) describes:
- pseudo-3D convs: a spatial k x k conv on each frame, then a causal
  temporal conv of k taps over the frames of each pixel (zeros before the
  first frame);
- a temporal PEG (a causal depthwise conv of 3 taps over the frames, with
  its input added) and causal temporal attention over the frames of each
  pixel after the stem and at every level: multi-query cosine-sim attention
  with a null key, a relative position bias from an MLP of the frame offset
  (a continuous position bias) and a learned bias of the null key;
- ResNet blocks with RMS norms, FiLM, text cross-attention over all (f h w)
  tokens and a global-context gate pooled over all of them;
- transformer blocks of full space-time attention over all (f h w) tokens,
  with the conditioning tokens in front of the keys, and a channel
  feedforward whose hidden half is shifted one frame forward (token shift);
- the 2-D U-Net's stem, conditioning (time, T5 tokens pooled by a Perceiver
  resampler), space-to-depth downsampling and pixel-shuffle upsampling,
  each frame alone; the conditioning is `reference.unet.Unet`'s own.

Activations are (b, c, f, h, w); the forward takes and returns clips
(b, f, H, W, 3). The parameter names and shapes are the port's `Unet3D`
`state_dict` keys, lucidrains' as the JAX package maps them, so one set of
weights loads into both. Departures from lucidrains, all the JAX package's
and the port's parameter layout: the relative position bias MLP and the
null key's bias sit in each temporal attention. The full space-time
attention is computed in blocks of queries so that a float32 step fits on
one card; the result is the same. Options outside the configuration's
raise. Every product goes through `numerics`, so the same code computes the
control in float8.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from port_bench.reference import numerics as nx
from port_bench.reference.unet import (
    AffineNorm,
    Attention,
    Conv,
    CrossAttention,
    Gain,
    Lin,
    Parallel,
    PerceiverResampler,
    SiLU,
    SinusoidalTime,
    ToTokens,
    Unet,
    attend,
    l2norm,
    layer_norm,
    merge_heads,
    per_level,
    split_heads,
)

SUPPORTED = dict(
    num_time_tokens=2, learned_sinu_pos_emb_dim=16, init_cross_embed=True,
    attn_pool_text=True, use_global_context_attn=True, scale_skip_connection=True,
    final_resnet_block=True, final_conv_kernel_size=3, pixel_shuffle_upsample=True,
    combine_upsample_fmaps=False, attend_at_middle=True, layer_attns_depth=1,
    init_conv_to_final_conv_residual=False, self_cond=False, memory_efficient=False,
    cond_dim=None, temporal_strides=1, time_causal_attn=True, time_rel_pos_bias_depth=2,
    ff_time_token_shift=True, temporal_fused_ln=False,
)
QUERY_BLOCK = 2048   # queries a block of the full space-time attention


def per_frame(fn, x):
    """`fn` of NCHW maps on each frame of x (b, c, f, h, w)."""
    b, c, f, h, w = x.shape
    out = fn(x.transpose(1, 2).reshape(b * f, c, h, w))
    return out.reshape(b, f, *out.shape[1:]).transpose(1, 2)


def to_tokens(x):
    """(b, c, f, h, w) -> (b, f*h*w, c), frames outermost."""
    return x.flatten(2).transpose(1, 2)


def from_tokens(t, like):
    return t.transpose(1, 2).reshape(like.shape[0], -1, *like.shape[2:])


def shift_frames(x, s):
    """x[:, :, f - s] at frame f, zeros before the first frame."""
    return F.pad(x, (0, 0, 0, 0, s, 0))[:, :, :x.shape[2]]


class UnitConv(nn.Module):
    """lucidrains' video `Conv2d`: a conv of kernel (1, k, k), weight
    (O, I, 1, k, k), SAME padding, on each frame alone."""

    def __init__(self, dim_in, dim_out, k, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim_out, dim_in, 1, k, k))
        self.bias = nn.Parameter(torch.empty(dim_out)) if bias else None
        self.pad = k // 2

    def forward(self, x):
        return per_frame(lambda t: nx.conv2d(t, self.weight[:, :, 0], self.bias,
                                             padding=self.pad), x)


class ChanLayerNorm(nn.Module):
    """LayerNorm over the channels, gain 'g' (1, C, 1, 1, 1)."""

    def __init__(self, dim):
        super().__init__()
        self.g = nn.Parameter(torch.empty(1, dim, 1, 1, 1))

    def forward(self, x):
        return layer_norm(x, self.g, dim=1)


class ChanRMSNorm(nn.Module):
    """x / ||x|| over the channels, times sqrt(C) and a gain 'gamma' (C, 1, 1)."""

    def __init__(self, dim):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim, 1, 1))

    def forward(self, x):
        return l2norm(x, dim=1) * x.shape[1] ** 0.5 * self.gamma.reshape(1, -1, 1, 1, 1)


class CausalTemporalConv(nn.Module):
    """A conv of k taps over the frames of each pixel, weight (O, I, k):
    out[f] = sum_j W[:, :, j] x[f + j - (k - 1)] + bias."""

    def __init__(self, dim, k):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, dim, k))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        k = self.weight.shape[-1]
        out = sum(nx.einsum('oi,bifhw->bofhw', self.weight[:, :, j], shift_frames(x, k - 1 - j))
                  for j in range(k))
        return out + self.bias.reshape(1, -1, 1, 1, 1)


class PseudoConv3d(nn.Module):
    def __init__(self, dim, dim_out, k=3):
        super().__init__()
        self.spatial_conv = Conv(dim, dim_out, k)
        self.temporal_conv = CausalTemporalConv(dim_out, k)

    def forward(self, x):
        return self.temporal_conv(per_frame(self.spatial_conv, x))


class BlockVideo(nn.Module):
    """RMS norm, FiLM, SiLU, pseudo-3D conv."""

    def __init__(self, dim, dim_out):
        super().__init__()
        self.norm = ChanRMSNorm(dim)
        self.project = PseudoConv3d(dim, dim_out)

    def forward(self, x, scale_shift=None):
        x = self.norm(x)
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1) + shift
        return self.project(F.silu(x))


class GlobalContext(nn.Module):
    """A softmax-pooled summary of the whole clip, through a bottleneck, as a
    sigmoid gate (b, c, 1, 1, 1)."""

    def __init__(self, dim_in, dim_out):
        super().__init__()
        hidden = max(3, dim_out // 2)
        self.to_k = UnitConv(dim_in, 1, 1)
        self.net = nn.Sequential(UnitConv(dim_in, hidden, 1), SiLU(), UnitConv(hidden, dim_out, 1),
                                 nn.Sigmoid())

    def forward(self, x):
        attn = torch.softmax(self.to_k(x).flatten(2), dim=-1)        # (b, 1, n)
        pooled = nx.einsum('bin,bcn->bci', attn, x.flatten(2))       # (b, c, 1)
        return self.net(pooled[..., None, None])


class ResnetBlockVideo(nn.Module):
    def __init__(self, dim, dim_out, time_cond_dim, cond_dim=None, use_gca=False,
                 dim_head=64, heads=8):
        super().__init__()
        self.time_mlp = nn.Sequential(SiLU(), Lin(time_cond_dim, dim_out * 2))
        self.cross_attn = CrossAttention(dim_out, cond_dim, dim_head, heads) \
            if cond_dim is not None else None
        self.block1 = BlockVideo(dim, dim_out)
        self.block2 = BlockVideo(dim_out, dim_out)
        self.gca = GlobalContext(dim_out, dim_out) if use_gca else None
        self.res_conv = UnitConv(dim, dim_out, 1) if dim != dim_out else None

    def forward(self, x, t, cond=None):
        h = self.block1(x)
        if self.cross_attn is not None:
            tok = to_tokens(h)
            h = from_tokens(self.cross_attn(tok, cond) + tok, h)
        scale_shift = self.time_mlp(t)[:, :, None, None, None].chunk(2, dim=1)
        h = self.block2(h, scale_shift)
        if self.gca is not None:
            h = h * self.gca(h)
        return h + (x if self.res_conv is None else self.res_conv(x))


class BlockedAttention(Attention):
    """`reference.unet.Attention` with its queries taken `QUERY_BLOCK` at a
    time, for the (f h w) tokens of a clip."""

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
        out = torch.cat([attend(q[:, :, i:i + QUERY_BLOCK], k, v, heads_k=False)
                         for i in range(0, q.shape[2], QUERY_BLOCK)], dim=2)
        return self.to_out(merge_heads(out))


class TimeTokenShift(nn.Module):
    """The second half of the channels one frame later (zeros at the first)."""

    def forward(self, x):
        keep, shift = x.chunk(2, dim=1)
        return torch.cat((keep, shift_frames(shift, 1)), dim=1)


class ChanFeedForward(nn.Sequential):
    """Channel LayerNorm, 1x1, GELU, token shift, channel LayerNorm, 1x1; no biases."""

    def __init__(self, dim, mult):
        hidden = int(dim * mult)
        super().__init__(ChanLayerNorm(dim), UnitConv(dim, hidden, 1, bias=False), nn.GELU(),
                         TimeTokenShift(), ChanLayerNorm(hidden),
                         UnitConv(hidden, dim, 1, bias=False))


class TransformerBlockVideo(nn.Module):
    def __init__(self, dim, dim_head, heads, ff_mult, context_dim):
        super().__init__()
        self.layers = nn.ModuleList([nn.ModuleList([
            BlockedAttention(dim, dim_head, heads, context_dim), ChanFeedForward(dim, ff_mult)])])

    def forward(self, x, context):
        for attn, ff in self.layers:
            t = to_tokens(x)
            x = from_tokens(attn(t, context) + t, x)
            x = ff(x) + x
        return x


class DynamicPositionBias(nn.Module):
    """An MLP of the frame offset i - j, a (heads, n, n) bias over n frames."""

    def __init__(self, dim, heads, depth):
        super().__init__()

        def hidden(dim_in):
            return nn.Sequential(Lin(dim_in, dim), Gain(dim), SiLU())

        self.mlp = nn.Sequential(hidden(1), *(hidden(dim) for _ in range(depth - 1)),
                                 Lin(dim, heads))

    def forward(self, n, device):
        pos = self.mlp(torch.arange(-n + 1, n, device=device, dtype=torch.float32)[:, None])
        i = torch.arange(n, device=device)
        return pos[i[:, None] - i[None, :] + n - 1].permute(2, 0, 1)


class TemporalSelfAttention(nn.Module):
    """Causal multi-query cosine-sim attention over the frames of each pixel,
    tokens (pixels, f, c): a null key and value first, with a learned bias
    per head, then the relative position bias over the frames."""

    def __init__(self, dim, dim_head, heads, depth):
        super().__init__()
        self.heads = heads
        self.norm = Gain(dim)
        self.null_kv = nn.Parameter(torch.empty(2, dim_head))
        self.to_q = Lin(dim, dim_head * heads, bias=False)
        self.to_kv = Lin(dim, dim_head * 2, bias=False)
        self.q_scale = nn.Parameter(torch.empty(dim_head))
        self.k_scale = nn.Parameter(torch.empty(dim_head))
        self.rel_pos_bias = DynamicPositionBias(dim, heads, depth)
        self.null_attn_bias = nn.Parameter(torch.empty(heads))
        self.to_out = nn.Sequential(Lin(dim_head * heads, dim, bias=False), Gain(dim))

    def forward(self, x):
        p, n, _ = x.shape
        x = self.norm(x)
        q = split_heads(self.to_q(x), self.heads)
        k, v = self.to_kv(x).chunk(2, dim=-1)
        k = torch.cat((self.null_kv[0].expand(p, 1, -1), k), dim=1)
        v = torch.cat((self.null_kv[1].expand(p, 1, -1), v), dim=1)
        q, k = l2norm(q) * self.q_scale, l2norm(k) * self.k_scale
        sim = nx.einsum('bhid,bjd->bhij', q, k) * 8.
        bias = torch.cat((self.null_attn_bias[:, None, None].expand(-1, n, 1),
                          self.rel_pos_bias(n, x.device)), dim=-1)
        causal = torch.ones((n, n + 1), dtype=torch.bool, device=x.device).triu(2)
        sim = (sim + bias).masked_fill(causal, -torch.finfo(sim.dtype).max)
        out = nx.einsum('bhij,bjd->bhid', torch.softmax(sim, dim=-1), v)
        return self.to_out(merge_heads(out))


class TimeCentric(nn.Module):
    """'b c f h w -> (b h w) f c' around `fn`, and back."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        b, c, f, h, w = x.shape
        out = self.fn(x.permute(0, 3, 4, 2, 1).reshape(b * h * w, f, c))
        return out.reshape(b, h, w, f, c).permute(0, 4, 3, 1, 2)


class Residual(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x) + x


def temporal_attention(dim, dim_head, heads, depth):
    return Residual(TimeCentric(TemporalSelfAttention(dim, dim_head, heads, depth)))


class PegConv(nn.Module):
    """Depthwise conv of 3 taps over frames, weight (C, 1, 3, 1, 1), causally
    padded (two zero frames before the first)."""

    def __init__(self, dim):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, 1, 3, 1, 1))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        f = x.shape[2]
        xp, w = nx.rounded(F.pad(x, (0, 0, 0, 0, 2, 0))), nx.rounded(self.weight)
        out = sum(xp[:, :, j:j + f] * w[:, 0, j].reshape(1, -1, 1, 1, 1) for j in range(3))
        return out + self.bias.reshape(1, -1, 1, 1, 1)


class TemporalPeg(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.fn = nn.Sequential(nn.Identity(), PegConv(dim))

    def forward(self, x):
        return self.fn(x) + x


class CrossEmbed(nn.Module):
    """Convs of several sizes on each frame, channels halved per scale, concatenated."""

    def __init__(self, dim_in, kernel_sizes, dim_out):
        super().__init__()
        kernel_sizes = sorted(kernel_sizes)
        dims = [int(dim_out / 2 ** i) for i in range(1, len(kernel_sizes))]
        dims.append(dim_out - sum(dims))
        self.convs = nn.ModuleList([UnitConv(dim_in, d, k) for k, d in zip(kernel_sizes, dims)])

    def forward(self, x):
        return torch.cat([conv(x) for conv in self.convs], dim=1)


class Framewise(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return per_frame(self.fn, x)


class PixelShuffleUpsample(nn.Module):
    def __init__(self, dim, dim_out):
        super().__init__()
        self.net = nn.Sequential(UnitConv(dim, dim_out * 4, 1), SiLU(),
                                 Framewise(nn.PixelShuffle(2)))

    def forward(self, x):
        return self.net(x)


class Unet3D(nn.Module):
    """The video U-Net; keyword names are lucidrains' `Unet3D`'s."""

    condition = Unet.condition
    _time = Unet._time

    def __init__(self, *, dim, dim_mults, num_resnet_blocks, layer_attns, layer_cross_attns,
                 attn_heads, attn_dim_head, ff_mult, text_embed_dim, max_text_len, lowres_cond,
                 init_cross_embed_kernel_sizes=(3, 7, 15), attn_pool_num_latents=32, **options):
        super().__init__()
        for key, value in options.items():
            if key not in SUPPORTED or SUPPORTED[key] != value:
                raise ValueError(f'the reference Unet3D does not implement {key}={value!r}')
        if lowres_cond:
            raise ValueError('the reference Unet3D does not implement lowres_cond=True')
        n = len(dim_mults)
        self.lowres_cond = False
        self.max_text_len = max_text_len
        cond_dim = dim
        time_cond_dim = dim * 4
        num_resnet_blocks = per_level(num_resnet_blocks, n)
        layer_attns = per_level(layer_attns, n)
        layer_cross_attns = per_level(layer_cross_attns, n)
        self.skip_scale = 2 ** -0.5
        depth = SUPPORTED['time_rel_pos_bias_depth']

        def temporal(d):
            return TemporalPeg(d), temporal_attention(d, attn_dim_head, attn_heads, depth)

        self.init_conv = CrossEmbed(3, init_cross_embed_kernel_sizes, dim)
        self.init_temporal_peg, self.init_temporal_attn = temporal(dim)

        # the conditioning heads of `reference.unet.Unet`, under its names
        self.to_time_hiddens = nn.Sequential(SinusoidalTime(16), Lin(17, time_cond_dim), SiLU())
        self.to_time_cond = nn.Sequential(Lin(time_cond_dim, time_cond_dim))
        self.to_time_tokens = nn.Sequential(Lin(time_cond_dim, cond_dim * 2), ToTokens(2))
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
        dims = [dim, *(dim * m for m in dim_mults)]
        in_out = list(zip(dims[:-1], dims[1:]))
        self.downs = nn.ModuleList()
        for i, (d_in, d_out) in enumerate(in_out):
            cross = cond_dim if layer_cross_attns[i] else None
            if i < n - 1:
                post = nn.Sequential(Framewise(nn.PixelUnshuffle(2)), UnitConv(d_in * 4, d_out, 1))
            else:
                post = Parallel(UnitConv(d_in, d_out, 3), UnitConv(d_in, d_out, 1))
            self.downs.append(nn.ModuleList([
                None,
                ResnetBlockVideo(d_in, d_in, time_cond_dim, cond_dim=cross, **head),
                nn.ModuleList([ResnetBlockVideo(d_in, d_in, time_cond_dim, use_gca=True, **head)
                               for _ in range(num_resnet_blocks[i])]),
                TransformerBlockVideo(d_in, attn_dim_head, attn_heads, ff_mult, cond_dim)
                if layer_attns[i] else None,
                *temporal(d_in),
                None,
                post,
            ]))

        mid = dims[-1]
        self.mid_block1 = ResnetBlockVideo(mid, mid, time_cond_dim, cond_dim=cond_dim)
        self.mid_attn = Residual(BlockedAttention(mid, attn_dim_head, attn_heads))
        self.mid_temporal_peg, self.mid_temporal_attn = temporal(mid)
        self.mid_block2 = ResnetBlockVideo(mid, mid, time_cond_dim, cond_dim=cond_dim)

        self.ups = nn.ModuleList()
        for i, (d_in, d_out) in enumerate(reversed(in_out)):
            level = n - 1 - i
            cross = cond_dim if layer_cross_attns[level] else None
            self.ups.append(nn.ModuleList([
                ResnetBlockVideo(d_out + d_in, d_out, time_cond_dim, cond_dim=cross, **head),
                nn.ModuleList([ResnetBlockVideo(d_out + d_in, d_out, time_cond_dim, use_gca=True,
                                                **head)
                               for _ in range(num_resnet_blocks[level])]),
                TransformerBlockVideo(d_out, attn_dim_head, attn_heads, ff_mult, cond_dim)
                if layer_attns[level] else None,
                *temporal(d_out),
                None,
                PixelShuffleUpsample(d_out, d_in) if i < n - 1 else None,
            ]))

        self.final_res_block = ResnetBlockVideo(dim, dim, time_cond_dim, use_gca=True, **head)
        self.final_conv = UnitConv(dim, 3, 3)

    def forward(self, x, time, *, text_embeds, text_mask, drop_text):
        """x (b, f, H, W, 3); returns the predicted noise (b, f, H, W, 3).
        `drop_text` (b,) bool replaces the text by the learned null embeddings."""
        x = self.init_conv(x.float().permute(0, 4, 1, 2, 3))
        x = self.init_temporal_attn(self.init_temporal_peg(x))
        t, c = self.condition(time, text_embeds, text_mask, drop_text)

        hiddens = []
        for _, init_block, blocks, attn, peg, temporal_attn, _, post in self.downs:
            x = init_block(x, t, c)
            for block in blocks:
                x = block(x, t)
                hiddens.append(x)
            if attn is not None:
                x = attn(x, c)
            x = temporal_attn(peg(x))
            hiddens.append(x)
            x = post(x)

        x = self.mid_block1(x, t, c)
        x = from_tokens(self.mid_attn(to_tokens(x)), x)
        x = self.mid_temporal_attn(self.mid_temporal_peg(x))
        x = self.mid_block2(x, t, c)

        for init_block, blocks, attn, peg, temporal_attn, _, up in self.ups:
            x = init_block(torch.cat((x, hiddens.pop() * self.skip_scale), dim=1), t, c)
            for block in blocks:
                x = block(torch.cat((x, hiddens.pop() * self.skip_scale), dim=1), t)
            if attn is not None:
                x = attn(x, c)
            x = temporal_attn(peg(x))
            if up is not None:
                x = up(x)

        x = self.final_res_block(x, t)
        return self.final_conv(x).permute(0, 2, 3, 4, 1)


def unet_kwargs(config):
    """The reference `Unet3D`'s keywords for a one-stage video configuration."""
    (spec,) = config['unets']
    return dict({k: v for k, v in spec.items() if k != 'unet'},
                text_embed_dim=config['text_embed_dim'], max_text_len=config['max_text_len'],
                lowres_cond=False)


def specs(config):
    """[(name, shape)] of the stage's parameters, from the reference."""
    with torch.device('meta'):
        unet = Unet3D(**unet_kwargs(config))
    return [(name, tuple(t.shape)) for name, t in unet.state_dict().items()]


def build(config, weights_of, device):
    """The stage's U-Net on `device`, holding `weights_of(0, specs)`."""
    with torch.device('meta'):
        unet = Unet3D(**unet_kwargs(config))
    unet.load_state_dict(weights_of(0, specs(config)), strict=True, assign=True)
    return unet.to(device).eval()
