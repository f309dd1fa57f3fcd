"""2D text-conditional denoising U-Net (torch.nn, NHWC); counterpart of
`imagen_tpu/models/unet2d.py`.

Inputs and outputs are NHWC, as in the JAX package. Submodules sit where
lucidrains' `Unet` keeps them (`downs.i.j`, `ups.i.j`, positional
Sequentials), so the parameter names are its `state_dict` keys.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from imagen_tpu_torch.models.blocks import (
    F32,
    Conv2d,
    CrossEmbedLayer,
    Downsample,
    LearnedSinusoidalPosEmb,
    Linear,
    LinearAttentionTransformerBlock,
    Conv1x1,
    Parallel,
    PerceiverResampler,
    PixelShuffleUpsample,
    ResnetBlock,
    TorchLayerNorm,
    TransformerBlock,
    Upsample,
    UpsampleCombiner,
)
from imagen_tpu_torch.models.unet_graphs import ForwardGraphs
from imagen_tpu_torch.ops.tensor_utils import prob_mask_like, resize_image_to, resize_kernel
from imagen_tpu_torch.parallel.rows import rows_of
from imagen_tpu_torch.utils.helpers import cast_tuple, default, exists, resolve_device
from imagen_tpu_torch.utils.profiling import span

DEFAULT_TEXT_EMBED_DIM = 768  # t5-v1_1-base d_model


class _Rearrange(nn.Module):
    """'b (r d) -> b r d'."""

    def __init__(self, r):
        super().__init__()
        self.r = r

    def forward(self, x):
        return x.reshape(x.shape[0], self.r, -1)


def input_channels(channels, lowres_cond, self_cond, cond_images_channels):
    """Channels into the init conv: the cond images, then x, the
    self-conditioning x_start and the low-res image, the JAX package's order,
    so one set of weights serves both."""
    return cond_images_channels + channels * (1 + int(self_cond) + int(lowres_cond))


class ConditionedUnet(nn.Module):
    """What the 2D and the video U-Net share: the time and text conditioning
    heads and their forward, the input channels of self-conditioning and
    cond images, the cascade's config correction, the device and the compute
    dtype. A subclass keeps its constructor arguments in `_config` and sets
    `channels`, `channels_out`, `lowres_cond`, `cond_on_text`,
    `text_embed_dim`, `max_text_len`, `self_cond`, `cond_images_channels`
    and `dtype`. The inference forward replays a CUDA graph where it can
    (`models/unet_graphs.py`)."""

    _forward_graphs = None   # a ForwardGraphs, made at the first forward

    def _apply(self, fn, *args, **kwargs):
        self._forward_graphs = None   # `.to()` and the like: the graphs read the old memory
        return super()._apply(fn, *args, **kwargs)

    def _graphed(self, run, **inputs):
        """`run(**inputs)`, or the replay of its CUDA graph (`ForwardGraphs`),
        with the text at `max_text_len` (`_fixed_text`)."""
        inputs['text_embeds'], inputs['text_mask'] = self._fixed_text(inputs['text_embeds'],
                                                                      inputs['text_mask'])
        if self._forward_graphs is None:
            self._forward_graphs = ForwardGraphs()
        return self._forward_graphs(self, run, **inputs)

    def _fixed_text(self, text_embeds, text_mask):
        """The text padded (masked off) or cut to `max_text_len` before its
        projection, as `_condition` pads and cuts the projected tokens: the
        forward's shapes then do not follow the prompt's length, and one CUDA
        graph serves every length. Only with a mask: without one the padded
        rows' projection (the bias) would differ from `_condition`'s zeros."""
        if not (self.cond_on_text and exists(text_embeds) and exists(text_mask)):
            return text_embeds, text_mask
        remainder = self.max_text_len - text_embeds.shape[1]
        if remainder > 0:
            text_embeds = F.pad(text_embeds, (0, 0, 0, remainder))
            text_mask = F.pad(text_mask, (0, remainder), value=False)
        return text_embeds[:, :self.max_text_len], text_mask[:, :self.max_text_len]

    def _append_self_cond(self, x, self_cond):
        """x with the self-conditioning x_start (zeros when None) appended on
        the channel axis, for a unet built with `self_cond`; a unet without
        ignores it, as the JAX one does."""
        if not self.self_cond:
            return x
        self_cond = torch.zeros_like(x) if self_cond is None else self_cond.to(x.dtype)
        return torch.cat((x, self_cond), dim=-1)

    def _check_cond_images(self, cond_images, ndim):
        if (self.cond_images_channels > 0) != exists(cond_images):
            raise ValueError('cond_images must be given if and only if the unet was built '
                             'with cond_images_channels')
        if exists(cond_images) and (cond_images.ndim != ndim
                                    or cond_images.shape[-1] != self.cond_images_channels):
            raise ValueError(f'cond_images of shape {tuple(cond_images.shape)}: expected '
                             f'{ndim} dims ending in {self.cond_images_channels} channels')

    def _build_conditioning(self, *, cond_dim, time_cond_dim, learned_sinu_pos_emb_dim,
                            num_time_tokens, attn_pool_text, attn_pool_num_latents,
                            attn_dim_head, attn_heads):
        dtype, sinu_dim = self.dtype, learned_sinu_pos_emb_dim

        def time_heads():
            hiddens = nn.Sequential(LearnedSinusoidalPosEmb(sinu_dim),
                                    Linear(sinu_dim + 1, time_cond_dim, dtype=dtype),
                                    nn.SiLU())
            cond = nn.Sequential(Linear(time_cond_dim, time_cond_dim, dtype=dtype))
            tokens = nn.Sequential(Linear(time_cond_dim, cond_dim * num_time_tokens,
                                          dtype=dtype), _Rearrange(num_time_tokens))
            return hiddens, cond, tokens

        self.to_time_hiddens, self.to_time_cond, self.to_time_tokens = time_heads()
        if self.lowres_cond:
            (self.to_lowres_time_hiddens, self.to_lowres_time_cond,
             self.to_lowres_time_tokens) = time_heads()

        self.norm_cond = TorchLayerNorm(cond_dim, dtype=dtype)
        if self.cond_on_text:
            if not exists(self.text_embed_dim):
                raise ValueError('text_embed_dim must be given when conditioning on text')
            self.text_to_cond = Linear(self.text_embed_dim, cond_dim, dtype=dtype)
            self.attn_pool = PerceiverResampler(
                cond_dim, depth=2, dim_head=attn_dim_head, heads=attn_heads,
                num_latents=attn_pool_num_latents, dtype=dtype) if attn_pool_text else None
            self.null_text_embed = nn.Parameter(torch.randn(1, self.max_text_len, cond_dim))
            self.null_text_hidden = nn.Parameter(torch.randn(1, time_cond_dim))
            self.to_text_non_attn_cond = nn.Sequential(
                TorchLayerNorm(cond_dim, dtype=dtype),
                Linear(cond_dim, time_cond_dim, dtype=dtype),
                nn.SiLU(),
                Linear(time_cond_dim, time_cond_dim, dtype=dtype),
            )

    @property
    def has_cond_image(self):
        return self.cond_images_channels > 0

    @property
    def channels_out_(self):
        return self.channels_out

    def forward_with_cond_scale(self, x, time, *, cond_scale=1., **kwargs):
        """The classifier-free guided forward: `unet_forward_with_cond_scale`
        (`diffusion/imagen.py`), the conditional and null halves as one
        doubled-batch forward."""
        from imagen_tpu_torch.diffusion.imagen import unet_forward_with_cond_scale
        return unet_forward_with_cond_scale(self, x, time, cond_scale=cond_scale, **kwargs)

    def cast_model_parameters(self, *, lowres_cond, text_embed_dim, channels, channels_out,
                              cond_on_text):
        """A unet with the cascade-corrected conditioning config (a new module
        with fresh weights), or self when nothing changes."""
        if (lowres_cond == self.lowres_cond
                and channels == self.channels
                and cond_on_text == self.cond_on_text
                and text_embed_dim == self.text_embed_dim
                and default(channels_out, channels) == self.channels_out):
            return self
        config = {**self._config, 'lowres_cond': lowres_cond,
                  'text_embed_dim': text_embed_dim, 'channels': channels,
                  'channels_out': channels_out, 'cond_on_text': cond_on_text}
        return type(self)(**config, device=self.device)

    @property
    def device(self):
        return next(self.parameters()).device

    def set_compute_dtype(self, dtype):
        """Compute in `dtype` from now on (parameters stay as they are): the
        trainer's `precision='bf16'`, like `unet.clone(dtype=...)` in JAX."""
        self.dtype = dtype
        self._config['dtype'] = dtype
        for m in self.modules():
            if hasattr(m, 'compute_dtype'):
                m.compute_dtype = dtype
        return self

    def _time_mlp(self, t_in, hiddens, cond, tokens):
        h = hiddens[0](t_in)
        h = hiddens[2](hiddens[1](h.to(self.dtype)))
        return cond(h), tokens(h)

    def _condition(self, time, *, lowres_noise_times, text_embeds, text_mask, cond_drop_prob,
                   force_text_drop_mask, generator):
        """The FiLM vector t (b, time_cond_dim) and the cross-attention tokens
        c (b, n, cond_dim). The text is dropped to the null embeddings with
        probability `cond_drop_prob`, drawn from `generator`;
        `force_text_drop_mask` (b,) bool overrides that draw, True dropping."""
        batch_size, device, dtype = time.shape[0], time.device, self.dtype
        t, time_tokens = self._time_mlp(time, self.to_time_hiddens, self.to_time_cond,
                                        self.to_time_tokens)
        if self.lowres_cond:
            lowres_t, lowres_time_tokens = self._time_mlp(
                lowres_noise_times, self.to_lowres_time_hiddens,
                self.to_lowres_time_cond, self.to_lowres_time_tokens)
            t = t + lowres_t
            time_tokens = torch.cat((time_tokens, lowres_time_tokens), dim=-2)

        text_tokens = None
        if exists(text_embeds) and self.cond_on_text:
            if exists(force_text_drop_mask):
                text_keep_mask = ~force_text_drop_mask.to(device)
            else:
                text_keep_mask = rows_of(lambda n: prob_mask_like(
                    (n,), 1 - cond_drop_prob, device, generator=generator), batch_size)
            text_keep_mask_embed = text_keep_mask[:, None, None]
            text_keep_mask_hidden = text_keep_mask[:, None]

            text_tokens = self.text_to_cond(text_embeds.to(dtype))
            text_tokens = text_tokens[:, :self.max_text_len]
            if exists(text_mask):
                text_mask = text_mask[:, :self.max_text_len]

            remainder = self.max_text_len - text_tokens.shape[1]
            if remainder > 0:
                text_tokens = F.pad(text_tokens, (0, 0, 0, remainder))
                if exists(text_mask):
                    text_mask = F.pad(text_mask, (0, remainder), value=False)

            if exists(text_mask):
                text_keep_mask_embed = text_mask[:, :, None] & text_keep_mask_embed

            text_tokens = torch.where(text_keep_mask_embed, text_tokens,
                                      self.null_text_embed.to(text_tokens.dtype))

            if exists(self.attn_pool):
                text_tokens = self.attn_pool(text_tokens)

            mean_pooled = text_tokens.mean(dim=-2)
            text_hiddens = self.to_text_non_attn_cond(mean_pooled)
            text_hiddens = torch.where(text_keep_mask_hidden, text_hiddens,
                                       self.null_text_hidden.to(text_hiddens.dtype))
            t = t + text_hiddens

        c = time_tokens if not exists(text_tokens) else torch.cat(
            (time_tokens, text_tokens), dim=-2)
        return t, self.norm_cond(c)


class Unet(ConditionedUnet):
    """The 2D denoiser. Keyword names mirror the JAX `Unet` attributes.

    `fused_film` is the JAX `IMAGEN_TPU_FUSED_FILM=1` carried as a keyword:
    every 2-D `Block` whose shape the gate admits runs its norm -> FiLM ->
    SiLU prologue as kernel 8. Off by default, as the JAX switch is.

    `use_linear_attn` (one flag, or one per level) puts a
    `LinearAttentionTransformerBlock` at a level without `layer_attns`;
    `use_linear_cross_attn` makes that level's cross-attention linear. In
    train mode their dropout draws from the forward's `generator`.
    `cross_embed_downsample` downsamples with a stride-2 `CrossEmbedLayer`
    of `cross_embed_downsample_kernel_sizes` (even kernels, so never kernel
    14, whose gate takes stride-1 stems). `remat` (False, True or
    'save_convs') recomputes every ResnetBlock, TransformerBlock and linear
    block in the backward pass while a gradient is recorded (see
    `blocks.ResnetBlock`). `resize_mode` is the `jax.image.resize` method
    that resizes `cond_images`; `dropout` is accepted and read nowhere, as
    in JAX."""

    def __init__(
        self,
        *,
        dim=128,
        text_embed_dim=DEFAULT_TEXT_EMBED_DIM,
        num_resnet_blocks=1,
        cond_dim=None,
        num_image_tokens=4,
        num_time_tokens=2,
        learned_sinu_pos_emb_dim=16,
        out_dim=None,
        dim_mults=(1, 2, 4, 8),
        cond_images_channels=0,
        channels=3,
        channels_out=None,
        attn_dim_head=64,
        attn_heads=8,
        ff_mult=2.,
        lowres_cond=False,
        layer_attns=True,
        layer_attns_depth=1,
        layer_mid_attns_depth=1,
        layer_attns_add_text_cond=True,
        attend_at_middle=True,
        layer_cross_attns=True,
        use_linear_attn=False,
        use_linear_cross_attn=False,
        cond_on_text=True,
        max_text_len=256,
        init_dim=None,
        init_conv_kernel_size=7,
        init_cross_embed=True,
        init_cross_embed_kernel_sizes=(3, 7, 15),
        cross_embed_downsample=False,
        cross_embed_downsample_kernel_sizes=(2, 4),
        attn_pool_text=True,
        attn_pool_num_latents=32,
        dropout=0.,
        memory_efficient=False,
        init_conv_to_final_conv_residual=False,
        use_global_context_attn=True,
        scale_skip_connection=True,
        final_resnet_block=True,
        final_conv_kernel_size=3,
        self_cond=False,
        resize_mode='nearest',
        combine_upsample_fmaps=False,
        pixel_shuffle_upsample=True,
        remat=False,
        fused_film=False,
        dtype=F32,
        device=None,
    ):
        super().__init__()
        with torch.device(resolve_device(device)):  # build on the card unless asked
            if attn_heads <= 1:
                raise ValueError('you need more than 1 attention head')
            resize_kernel(resize_mode)   # raises on an unknown method

            # constructor arguments, for cast_model_parameters
            self._config = {k: v for k, v in locals().items()
                            if k not in ('self', '__class__', 'device')}

            self.channels = channels
            self.channels_out = default(channels_out, channels)
            self.lowres_cond = lowres_cond
            self.cond_on_text = cond_on_text
            self.text_embed_dim = text_embed_dim
            self.max_text_len = max_text_len
            self.dtype = dtype
            self.self_cond = self_cond
            self.cond_images_channels = cond_images_channels
            self.resize_mode = resize_mode

            num_layers = len(dim_mults)
            init_dim = default(init_dim, dim)
            cond_dim = default(cond_dim, dim)
            time_cond_dim = dim * 4 * (2 if lowres_cond else 1)
            self.skip_connect_scale = 1. if not scale_skip_connection else 2 ** -0.5

            num_resnet_blocks = cast_tuple(num_resnet_blocks, num_layers)
            layer_attns = cast_tuple(layer_attns, num_layers)
            layer_attns_depth = cast_tuple(layer_attns_depth, num_layers)
            layer_cross_attns = cast_tuple(layer_cross_attns, num_layers)
            use_linear_attn = cast_tuple(use_linear_attn, num_layers)
            use_linear_cross_attn = cast_tuple(use_linear_cross_attn, num_layers)

            dims = [init_dim, *(dim * m for m in dim_mults)]
            in_out = list(zip(dims[:-1], dims[1:]))
            attn_kwargs = dict(heads=attn_heads, dim_head=attn_dim_head)
            resnet_kwargs = dict(attn_dim_head=attn_dim_head, attn_heads=attn_heads, dtype=dtype,
                                 fused_film=fused_film, remat=remat)

            init_channels = input_channels(channels, lowres_cond, self_cond, cond_images_channels)
            if init_cross_embed:
                self.init_conv = CrossEmbedLayer(init_channels, init_cross_embed_kernel_sizes,
                                                 dim_out=init_dim, stride=1, dtype=dtype)
            else:
                k = init_conv_kernel_size
                self.init_conv = Conv2d(init_channels, init_dim, k, padding=k // 2, dtype=dtype)
            self.init_conv_to_final_conv_residual = init_conv_to_final_conv_residual

            self._build_conditioning(
                cond_dim=cond_dim, time_cond_dim=time_cond_dim,
                learned_sinu_pos_emb_dim=learned_sinu_pos_emb_dim,
                num_time_tokens=num_time_tokens, attn_pool_text=attn_pool_text,
                attn_pool_num_latents=attn_pool_num_latents, attn_dim_head=attn_dim_head,
                attn_heads=attn_heads)

            self.init_resnet_block = ResnetBlock(
                init_dim, init_dim, time_cond_dim=time_cond_dim,
                use_gca=use_global_context_attn, **resnet_kwargs) if memory_efficient else None

            def transformer(layer_attn, linear, depth, dim_):
                if layer_attn:
                    return TransformerBlock(dim_, depth=depth, ff_mult=ff_mult,
                                            context_dim=cond_dim, dtype=dtype, remat=remat,
                                            **attn_kwargs)
                if linear:
                    return LinearAttentionTransformerBlock(
                        dim_, depth=depth, ff_mult=ff_mult, context_dim=cond_dim, dtype=dtype,
                        remat=remat, **attn_kwargs)
                return None

            def downsample(dim_in, dim_out):
                if cross_embed_downsample:
                    return CrossEmbedLayer(dim_in, cross_embed_downsample_kernel_sizes,
                                           dim_out=dim_out, stride=2, dtype=dtype)
                return Downsample(dim_in, dim_out, dtype=dtype)

            # down path: [pre_downsample, init block, blocks, transformer, post_downsample]
            self.downs = nn.ModuleList()
            for ind, ((dim_in, dim_out), nblocks, layer_attn, attn_depth, layer_cross_attn,
                      lin_attn, lin_cross) in enumerate(zip(
                          in_out, num_resnet_blocks, layer_attns, layer_attns_depth,
                          layer_cross_attns, use_linear_attn, use_linear_cross_attn)):
                is_last = ind >= (num_layers - 1)
                layer_cond_dim = cond_dim if (layer_cross_attn or lin_cross) else None
                current_dim = dim_out if memory_efficient else dim_in
                pre = downsample(dim_in, dim_out) if memory_efficient else None
                if memory_efficient:
                    post = None
                elif not is_last:
                    post = downsample(current_dim, dim_out)
                else:
                    post = Parallel(Conv2d(dim_in, dim_out, 3, padding=1, dtype=dtype),
                                    Conv1x1(dim_in, dim_out, dtype=dtype))
                self.downs.append(nn.ModuleList([
                    pre,
                    ResnetBlock(current_dim, current_dim, cond_dim=layer_cond_dim,
                                time_cond_dim=time_cond_dim, linear_attn=lin_cross,
                                **resnet_kwargs),
                    nn.ModuleList([
                        ResnetBlock(current_dim, current_dim, time_cond_dim=time_cond_dim,
                                    use_gca=use_global_context_attn, **resnet_kwargs)
                        for _ in range(nblocks)]),
                    transformer(layer_attn, lin_attn, attn_depth, current_dim),
                    post,
                ]))

            # middle: plain ResnetBlocks, so their cross-attention keeps the defaults
            mid_dim = dims[-1]
            self.mid_block1 = ResnetBlock(mid_dim, mid_dim, cond_dim=cond_dim,
                                          time_cond_dim=time_cond_dim, dtype=dtype,
                                          fused_film=fused_film, remat=remat)
            self.mid_attn = TransformerBlock(
                mid_dim, depth=layer_mid_attns_depth, dtype=dtype, remat=remat,
                **attn_kwargs) if attend_at_middle else None
            self.mid_block2 = ResnetBlock(mid_dim, mid_dim, cond_dim=cond_dim,
                                          time_cond_dim=time_cond_dim, dtype=dtype,
                                          fused_film=fused_film, remat=remat)

            # up path: [init block, blocks, transformer, upsample]
            upsample_klass = PixelShuffleUpsample if pixel_shuffle_upsample else Upsample
            self.ups = nn.ModuleList()
            upsample_fmap_dims = []
            skip_dims = [dim_out if memory_efficient else dim_in for dim_in, dim_out in in_out]
            rev = lambda tup: tuple(reversed(tup))  # noqa: E731
            for ind, ((dim_in, dim_out), nblocks, layer_attn, attn_depth, layer_cross_attn,
                      lin_attn, lin_cross) in enumerate(zip(
                          rev(in_out), rev(num_resnet_blocks), rev(layer_attns),
                          rev(layer_attns_depth), rev(layer_cross_attns), rev(use_linear_attn),
                          rev(use_linear_cross_attn))):
                is_last = ind == (num_layers - 1)
                layer_cond_dim = cond_dim if (layer_cross_attn or lin_cross) else None
                skip_dim = skip_dims[num_layers - 1 - ind]
                upsample_fmap_dims.append(dim_out)
                self.ups.append(nn.ModuleList([
                    ResnetBlock(dim_out + skip_dim, dim_out, cond_dim=layer_cond_dim,
                                time_cond_dim=time_cond_dim, linear_attn=lin_cross,
                                **resnet_kwargs),
                    nn.ModuleList([
                        ResnetBlock(dim_out + skip_dim, dim_out, time_cond_dim=time_cond_dim,
                                    use_gca=use_global_context_attn, **resnet_kwargs)
                        for _ in range(nblocks)]),
                    transformer(layer_attn, lin_attn, attn_depth, dim_out),
                    upsample_klass(dim_out, dim_in, dtype=dtype)
                    if (not is_last or memory_efficient) else None,
                ]))

            self.upsample_combiner = UpsampleCombiner(
                dim, enabled=combine_upsample_fmaps, dim_ins=tuple(upsample_fmap_dims),
                dim_outs=dim, dtype=dtype, fused_film=fused_film)

            final_conv_dim = self.upsample_combiner.dim_out
            if init_conv_to_final_conv_residual:
                final_conv_dim += init_dim
            self.final_res_block = ResnetBlock(
                final_conv_dim, dim, time_cond_dim=time_cond_dim, use_gca=True,
                **resnet_kwargs) if final_resnet_block else None
            final_conv_dim_in = dim if final_resnet_block else final_conv_dim
            final_conv_dim_in += channels if lowres_cond else 0
            k = final_conv_kernel_size
            self.final_conv = Conv2d(final_conv_dim_in, self.channels_out, k, padding=k // 2,
                                     dtype=dtype)
            nn.init.zeros_(self.final_conv.weight)
            nn.init.zeros_(self.final_conv.bias)

    def forward(self, x, time, *, lowres_cond_img=None, lowres_noise_times=None,
                text_embeds=None, text_mask=None, cond_images=None, self_cond=None,
                cond_drop_prob=0., force_text_drop_mask=None, generator=None):
        """x (b, H, W, c) NHWC. The text is dropped to the null embeddings with
        probability `cond_drop_prob`, drawn from `generator`.
        `force_text_drop_mask` (b,) bool overrides that draw, True dropping:
        classifier-free guidance runs the conditional and null halves as one
        doubled-batch forward. `cond_images` (b, h, w, cond_images_channels),
        resized to x, and `self_cond` (b, H, W, c), the previous x_start, go
        in on the channel axis. An inference call on the card may replay a
        CUDA graph of this forward (`models/unet_graphs.py`)."""
        with span('unet.forward'):
            return self._graphed(
                self._forward, x=x, time=time, lowres_cond_img=lowres_cond_img,
                lowres_noise_times=lowres_noise_times, text_embeds=text_embeds,
                text_mask=text_mask, cond_images=cond_images, self_cond=self_cond,
                cond_drop_prob=cond_drop_prob, force_text_drop_mask=force_text_drop_mask,
                generator=generator)

    def _forward(self, x, time, *, lowres_cond_img, lowres_noise_times, text_embeds, text_mask,
                 cond_images, self_cond, cond_drop_prob, force_text_drop_mask, generator=None):
        if self.lowres_cond and not (exists(lowres_cond_img) and exists(lowres_noise_times)):
            raise ValueError('low resolution conditioning image and noise times must be '
                             'present')
        self._check_cond_images(cond_images, 4)
        x = self._append_self_cond(x, self_cond)
        if exists(lowres_cond_img):
            x = torch.cat((x, lowres_cond_img.to(x.dtype)), dim=-1)
        if exists(cond_images):
            cond_images = resize_image_to(cond_images, x.shape[-2], method=self.resize_mode)
            x = torch.cat((cond_images.to(x.dtype), x), dim=-1)

        x = self.init_conv(x)
        init_conv_residual = x if self.init_conv_to_final_conv_residual else None

        t, c = self._condition(
            time, lowres_noise_times=lowres_noise_times, text_embeds=text_embeds,
            text_mask=text_mask, cond_drop_prob=cond_drop_prob,
            force_text_drop_mask=force_text_drop_mask, generator=generator)

        if exists(self.init_resnet_block):
            x = self.init_resnet_block(x, time_emb=t)

        hiddens = []
        for (pre_downsample, init_block, resnet_blocks, attn_block,
             post_downsample) in self.downs:
            if exists(pre_downsample):
                x = pre_downsample(x)
            x = init_block(x, time_emb=t, cond=c)
            for resnet_block in resnet_blocks:
                x = resnet_block(x, time_emb=t)
                hiddens.append(x)
            if exists(attn_block):
                x = attn_block(x, context=c, generator=generator)
            hiddens.append(x)
            if exists(post_downsample):
                x = post_downsample(x)

        x = self.mid_block1(x, time_emb=t, cond=c)
        if exists(self.mid_attn):
            x = self.mid_attn(x)
        x = self.mid_block2(x, time_emb=t, cond=c)

        def add_skip(x):
            return torch.cat((x, hiddens.pop() * self.skip_connect_scale), dim=-1)

        up_hiddens = []
        for init_block, resnet_blocks, attn_block, upsample in self.ups:
            x = init_block(add_skip(x), time_emb=t, cond=c)
            for resnet_block in resnet_blocks:
                x = resnet_block(add_skip(x), time_emb=t)
            if exists(attn_block):
                x = attn_block(x, context=c, generator=generator)
            up_hiddens.append(x)
            if exists(upsample):
                x = upsample(x)

        x = self.upsample_combiner(x, up_hiddens)

        if exists(init_conv_residual):
            x = torch.cat((x, init_conv_residual), dim=-1)

        if exists(self.final_res_block):
            x = self.final_res_block(x, time_emb=t)

        if exists(lowres_cond_img):
            x = torch.cat((x, lowres_cond_img.to(x.dtype)), dim=-1)

        return self.final_conv(x)


class NullUnet(nn.Module):
    """Identity placeholder for a skipped cascade stage."""

    self_cond = False
    cond_images_channels = 0

    def __init__(self, lowres_cond=False, channels=3, device=None):
        super().__init__()
        self.lowres_cond = lowres_cond
        self.channels = channels
        self.channels_out = channels
        self.dummy = nn.Parameter(torch.zeros(1, device=resolve_device(device)))

    @property
    def has_cond_image(self):
        return False

    @property
    def channels_out_(self):
        return self.channels

    def cast_model_parameters(self, *, lowres_cond=False, **kwargs):
        if lowres_cond == self.lowres_cond:
            return self
        return NullUnet(lowres_cond=lowres_cond, channels=self.channels,
                        device=self.dummy.device)

    def forward(self, x, *args, **kwargs):
        return x


# --- presets of the Imagen paper appendix -----------------------------------------------

def BaseUnet64(**kwargs):
    base = dict(
        dim=512,
        dim_mults=(1, 2, 3, 4),
        num_resnet_blocks=3,
        layer_attns=(False, True, True, True),
        layer_cross_attns=(False, True, True, True),
        attn_heads=8,
        ff_mult=2.,
        memory_efficient=False,
    )
    return Unet(**{**base, **kwargs})


def SRUnet256(**kwargs):
    base = dict(
        dim=128,
        dim_mults=(1, 2, 4, 8),
        num_resnet_blocks=(2, 4, 8, 8),
        layer_attns=(False, False, False, True),
        layer_cross_attns=(False, False, False, True),
        attn_heads=8,
        ff_mult=2.,
        memory_efficient=True,
    )
    return Unet(**{**base, **kwargs})


def SRUnet1024(**kwargs):
    base = dict(
        dim=128,
        dim_mults=(1, 2, 4, 8),
        num_resnet_blocks=(2, 4, 8, 8),
        layer_attns=False,
        layer_cross_attns=(False, False, False, True),
        attn_heads=8,
        ff_mult=2.,
        memory_efficient=True,
    )
    return Unet(**{**base, **kwargs})
