"""Pseudo-3D video denoising U-Net (torch.nn, NFHWC); counterpart of
`imagen_tpu/models/unet3d.py`.

Inputs and outputs are (batch, frames, height, width, channels), as in the
JAX package. Submodules sit where lucidrains' `Unet3D` keeps them
(`downs.i.j`, `ups.i.j`, `Residual` and time-centric wrappers as `.fn`), so
the parameter names are its `state_dict` keys:

    downs.i: 0 pre-downsample, 1 init resnet, 2 resnets, 3 transformer,
             4 temporal PEG, 5 temporal attention, 6 temporal downsample,
             7 post-downsample
    ups.i:   0 init resnet, 1 resnets, 2 transformer, 3 temporal PEG,
             4 temporal attention, 5 temporal upsample, 6 upsample

Ported: temporal strides, `ignore_time` (train or run on still images),
`lowres_cond`, `memory_efficient`, conditioning on preceding frames
(`cond_video_frames`, prepended) and succeeding frames
(`post_cond_video_frames`, appended, as the JAX package does),
`cast_model_parameters`, self-conditioning (`self_cond`), cond images
(`cond_images_channels`: a (b, h, w, c) image repeated over every frame,
prompt frames included, resized with `resize_mode`), `temporal_fused_ln`,
the JAX package's `IMAGEN_TPU_TEMPORAL_FUSED_LN=1` as a constructor
keyword (off by default): the temporal attention sites with c >= 128 then
run their LayerNorm and out-norm fused with the fold and unfold (kernels 12
and 13, `ops/temporal_layout.py`); `use_linear_attn` (a per-frame
`LinearAttentionTransformerBlockVideo` at every level without
`layer_attns`), `use_linear_cross_attn` (linear cross-attention at the
levels without `layer_cross_attns`), `cross_embed_downsample` (a stride-2
`CrossEmbedLayer` per frame, never kernel 14) and `remat` (True: every
`ResnetBlockVideo` recomputed in the backward pass while a gradient is
recorded). `dropout` is accepted and read nowhere, as in JAX.
"""
from __future__ import annotations

import functools
import operator

import torch
from torch import nn

from imagen_tpu_torch.models.blocks import (
    F32,
    Conv1x1,
    CrossEmbedLayer,
    Downsample,
    Parallel,
    PixelShuffleUpsample,
    Upsample,
)
from imagen_tpu_torch.models.unet2d import (
    DEFAULT_TEXT_EMBED_DIM,
    ConditionedUnet,
    input_channels,
)
from imagen_tpu_torch.models.video_blocks import (
    LinearAttentionTransformerBlockVideo,
    ResnetBlockVideo,
    Residual,
    SpatialConvIn3d,
    TemporalAttention,
    TemporalDownsample,
    TemporalPeg,
    TemporalPixelShuffleUpsample,
    TransformerBlockVideo,
    UpsampleCombinerVideo,
    VideoAttention,
    resize_video_to,
    spatial,
    unit_time,
)
from imagen_tpu_torch.ops.tensor_utils import resize_kernel
from imagen_tpu_torch.utils.helpers import cast_tuple, default, exists, resolve_device
from imagen_tpu_torch.utils.profiling import span


def temporal(peg, attn, x):
    """A level's temporal PEG, then its temporal attention, in a
    `video.temporal` span."""
    with span('video.temporal'):
        return attn(peg(x))


class Unet3D(ConditionedUnet):
    """The video denoiser. Keyword names mirror the JAX `Unet3D` attributes."""

    is_video_unet = True

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
        temporal_strides=1,
        cond_images_channels=0,
        channels=3,
        channels_out=None,
        attn_dim_head=64,
        attn_heads=8,
        ff_mult=2.,
        ff_time_token_shift=True,
        lowres_cond=False,
        layer_attns=False,
        layer_attns_depth=1,
        layer_attns_add_text_cond=True,
        attend_at_middle=True,
        time_rel_pos_bias_depth=2,
        time_causal_attn=True,
        temporal_fused_ln=False,
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
        combine_upsample_fmaps=False,
        pixel_shuffle_upsample=True,
        resize_mode='nearest',
        remat=False,
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
            self.self_cond = self_cond
            self.cond_images_channels = cond_images_channels
            self.resize_mode = resize_mode
            self.dtype = dtype

            num_layers = len(dim_mults)
            init_dim = default(init_dim, dim)
            cond_dim = default(cond_dim, dim)
            time_cond_dim = dim * 4 * (2 if lowres_cond else 1)
            self.skip_connect_scale = 1. if not scale_skip_connection else 2 ** -0.5

            num_resnet_blocks = cast_tuple(num_resnet_blocks, num_layers)
            layer_attns = cast_tuple(layer_attns, num_layers)
            layer_attns_depth = cast_tuple(layer_attns_depth, num_layers)
            layer_cross_attns = cast_tuple(layer_cross_attns, num_layers)
            temporal_strides = cast_tuple(temporal_strides, num_layers)
            self.temporal_strides = temporal_strides

            dims = [init_dim, *(dim * m for m in dim_mults)]
            in_out = list(zip(dims[:-1], dims[1:]))
            attn_kwargs = dict(heads=attn_heads, dim_head=attn_dim_head)
            temporal_kwargs = dict(causal=time_causal_attn, dtype=dtype)
            temporal_attn_kwargs = dict(rel_pos_bias_mlp_depth=time_rel_pos_bias_depth,
                                        fused_ln=temporal_fused_ln, **attn_kwargs,
                                        **temporal_kwargs)
            resnet_kwargs = dict(attn_dim_head=attn_dim_head, attn_heads=attn_heads,
                                 dtype=dtype, remat=remat)

            def peg(d):
                return TemporalPeg(d, **temporal_kwargs)

            def temporal_attn(d):
                return TemporalAttention(d, **temporal_attn_kwargs)

            init_channels = input_channels(channels, lowres_cond, self_cond,
                                           cond_images_channels)
            if init_cross_embed:
                self.init_conv = unit_time(CrossEmbedLayer(
                    init_channels, init_cross_embed_kernel_sizes, dim_out=init_dim, stride=1,
                    dtype=dtype))
            else:
                self.init_conv = SpatialConvIn3d(init_channels, init_dim,
                                                 kernel=init_conv_kernel_size, dtype=dtype)
            self.init_temporal_peg = peg(init_dim)
            self.init_temporal_attn = temporal_attn(init_dim)
            self.init_conv_to_final_conv_residual = init_conv_to_final_conv_residual

            self._build_conditioning(
                cond_dim=cond_dim, time_cond_dim=time_cond_dim,
                learned_sinu_pos_emb_dim=learned_sinu_pos_emb_dim,
                num_time_tokens=num_time_tokens, attn_pool_text=attn_pool_text,
                attn_pool_num_latents=attn_pool_num_latents, attn_dim_head=attn_dim_head,
                attn_heads=attn_heads)

            self.init_resnet_block = ResnetBlockVideo(
                init_dim, init_dim, time_cond_dim=time_cond_dim,
                use_gca=use_global_context_attn, **resnet_kwargs) if memory_efficient else None

            def transformer(layer_attn, depth, dim_):
                klass = (TransformerBlockVideo if layer_attn else
                         LinearAttentionTransformerBlockVideo if use_linear_attn else None)
                if klass is None:
                    return None
                return klass(dim_, depth=depth, ff_mult=ff_mult,
                             ff_time_token_shift=ff_time_token_shift, context_dim=cond_dim,
                             dtype=dtype, **attn_kwargs)

            def downsample(dim_in, dim_out):
                if cross_embed_downsample:
                    return unit_time(CrossEmbedLayer(
                        dim_in, cross_embed_downsample_kernel_sizes, dim_out=dim_out, stride=2,
                        dtype=dtype))
                return unit_time(Downsample(dim_in, dim_out, dtype=dtype))

            self.downs = nn.ModuleList()
            for ind, ((dim_in, dim_out), nblocks, layer_attn, attn_depth, layer_cross_attn,
                      stride) in enumerate(zip(in_out, num_resnet_blocks, layer_attns,
                                               layer_attns_depth, layer_cross_attns,
                                               temporal_strides)):
                is_last = ind >= (num_layers - 1)
                linear_cross = not layer_cross_attn and use_linear_cross_attn
                layer_cond_dim = cond_dim if (layer_cross_attn or linear_cross) else None
                current_dim = dim_out if memory_efficient else dim_in
                pre = downsample(dim_in, dim_out) if memory_efficient else None
                if memory_efficient:
                    post = None
                elif not is_last:
                    post = downsample(current_dim, dim_out)
                else:
                    post = Parallel(SpatialConvIn3d(dim_in, dim_out, kernel=3, dtype=dtype),
                                    unit_time(Conv1x1(dim_in, dim_out, dtype=dtype)))
                self.downs.append(nn.ModuleList([
                    pre,
                    ResnetBlockVideo(current_dim, current_dim, cond_dim=layer_cond_dim,
                                     time_cond_dim=time_cond_dim, linear_attn=linear_cross,
                                     **resnet_kwargs),
                    nn.ModuleList([
                        ResnetBlockVideo(current_dim, current_dim, time_cond_dim=time_cond_dim,
                                         use_gca=use_global_context_attn, **resnet_kwargs)
                        for _ in range(nblocks)]),
                    transformer(layer_attn, attn_depth, current_dim),
                    peg(current_dim),
                    temporal_attn(current_dim),
                    TemporalDownsample(current_dim, current_dim, stride=stride, dtype=dtype)
                    if stride > 1 else None,
                    post,
                ]))

            # middle: mid blocks keep CrossAttention's defaults (dim_head 64, heads 8)
            mid_dim = dims[-1]
            self.mid_block1 = ResnetBlockVideo(mid_dim, mid_dim, cond_dim=cond_dim,
                                               time_cond_dim=time_cond_dim, dtype=dtype,
                                               remat=remat)
            self.mid_attn = Residual(VideoAttention(mid_dim, dtype=dtype, **attn_kwargs)) \
                if attend_at_middle else None
            self.mid_temporal_peg = peg(mid_dim)
            self.mid_temporal_attn = temporal_attn(mid_dim)
            self.mid_block2 = ResnetBlockVideo(mid_dim, mid_dim, cond_dim=cond_dim,
                                               time_cond_dim=time_cond_dim, dtype=dtype,
                                               remat=remat)

            upsample_klass = PixelShuffleUpsample if pixel_shuffle_upsample else Upsample
            self.ups = nn.ModuleList()
            upsample_fmap_dims = []
            skip_dims = [dim_out if memory_efficient else dim_in for dim_in, dim_out in in_out]
            rev = lambda tup: tuple(reversed(tup))  # noqa: E731
            for ind, ((dim_in, dim_out), nblocks, layer_attn, attn_depth, layer_cross_attn,
                      stride) in enumerate(zip(rev(in_out), rev(num_resnet_blocks),
                                               rev(layer_attns), rev(layer_attns_depth),
                                               rev(layer_cross_attns), rev(temporal_strides))):
                is_last = ind == (num_layers - 1)
                linear_cross = not layer_cross_attn and use_linear_cross_attn
                layer_cond_dim = cond_dim if (layer_cross_attn or linear_cross) else None
                skip_dim = skip_dims[num_layers - 1 - ind]
                upsample_fmap_dims.append(dim_out)
                self.ups.append(nn.ModuleList([
                    ResnetBlockVideo(dim_out + skip_dim, dim_out, cond_dim=layer_cond_dim,
                                     time_cond_dim=time_cond_dim, linear_attn=linear_cross,
                                     **resnet_kwargs),
                    nn.ModuleList([
                        ResnetBlockVideo(dim_out + skip_dim, dim_out, time_cond_dim=time_cond_dim,
                                         use_gca=use_global_context_attn, **resnet_kwargs)
                        for _ in range(nblocks)]),
                    transformer(layer_attn, attn_depth, dim_out),
                    peg(dim_out),
                    temporal_attn(dim_out),
                    TemporalPixelShuffleUpsample(dim_out, dim_out, stride=stride, dtype=dtype)
                    if stride > 1 else None,
                    unit_time(upsample_klass(dim_out, dim_in, dtype=dtype))
                    if (not is_last or memory_efficient) else None,
                ]))

            self.upsample_combiner = UpsampleCombinerVideo(
                dim, enabled=combine_upsample_fmaps, dim_ins=tuple(upsample_fmap_dims),
                dim_outs=dim, dtype=dtype)

            final_conv_dim = self.upsample_combiner.dim_out
            if init_conv_to_final_conv_residual:
                final_conv_dim += init_dim
            self.final_res_block = ResnetBlockVideo(
                final_conv_dim, dim, time_cond_dim=time_cond_dim, use_gca=True,
                **resnet_kwargs) if final_resnet_block else None
            final_conv_dim_in = dim if final_resnet_block else final_conv_dim
            final_conv_dim_in += channels if lowres_cond else 0
            self.final_conv = SpatialConvIn3d(final_conv_dim_in, self.channels_out,
                                              kernel=final_conv_kernel_size, dtype=dtype)
            nn.init.zeros_(self.final_conv.weight)
            nn.init.zeros_(self.final_conv.bias)

    @property
    def total_temporal_divisor(self):
        """The product of the levels' temporal strides: the frames a clip
        must be a multiple of."""
        return functools.reduce(operator.mul, self.temporal_strides, 1)

    def forward(self, x, time, *, lowres_cond_img=None, lowres_noise_times=None,
                text_embeds=None, text_mask=None, cond_images=None, self_cond=None,
                cond_video_frames=None, post_cond_video_frames=None, cond_drop_prob=0.,
                force_text_drop_mask=None, ignore_time=False, generator=None):
        """x (b, f, H, W, c) NFHWC. The text is dropped to the null embeddings
        with probability `cond_drop_prob`, drawn from `generator`;
        `force_text_drop_mask` (b,) bool overrides that draw (classifier-free
        guidance). `ignore_time` skips every temporal module, so the net runs
        on each frame as an image net. `self_cond` (b, f, H, W, c) goes in on
        the channel axis before the low-res video; `cond_images` (b, h, w, c')
        is repeated over every frame, prompt frames included, and resized.
        An inference call on the card may replay a CUDA graph of this forward
        (`models/unet_graphs.py`)."""
        with span('unet.forward'):
            return self._graphed(
                self._forward, x=x, time=time, lowres_cond_img=lowres_cond_img,
                lowres_noise_times=lowres_noise_times, text_embeds=text_embeds,
                text_mask=text_mask, cond_images=cond_images, self_cond=self_cond,
                cond_video_frames=cond_video_frames,
                post_cond_video_frames=post_cond_video_frames, cond_drop_prob=cond_drop_prob,
                force_text_drop_mask=force_text_drop_mask, ignore_time=ignore_time,
                generator=generator)

    def _forward(self, x, time, *, lowres_cond_img, lowres_noise_times, text_embeds, text_mask,
                 cond_images, self_cond, cond_video_frames, post_cond_video_frames,
                 cond_drop_prob, force_text_drop_mask, ignore_time, generator=None):
        if x.ndim != 5:
            raise ValueError('input to the 3D unet must be (batch, frames, h, w, channels)')
        frames = x.shape[1]
        if not ignore_time and frames % self.total_temporal_divisor:
            raise ValueError(f'frames {frames} must divide by the total temporal divisor '
                             f'{self.total_temporal_divisor}')

        if self.lowres_cond and not (exists(lowres_cond_img) and exists(lowres_noise_times)):
            raise ValueError('low resolution conditioning video and noise times must be '
                             'present')
        self._check_cond_images(cond_images, 4)
        x = self._append_self_cond(x, self_cond)
        if exists(lowres_cond_img):
            x = torch.cat((x, lowres_cond_img.to(x.dtype)), dim=-1)
            # prompt frames double their channels to match the (x ++ lowres) layout
            if exists(cond_video_frames):
                lowres_cond_img = torch.cat((cond_video_frames, lowres_cond_img), dim=1)
                cond_video_frames = torch.cat((cond_video_frames, cond_video_frames), dim=-1)
            if exists(post_cond_video_frames):
                lowres_cond_img = torch.cat((lowres_cond_img, post_cond_video_frames), dim=1)
                post_cond_video_frames = torch.cat(
                    (post_cond_video_frames, post_cond_video_frames), dim=-1)

        # prompt frames: preceding ones prepended, succeeding ones appended
        num_preceding_frames = num_succeeding_frames = 0
        for frames_, before in ((cond_video_frames, True), (post_cond_video_frames, False)):
            if not exists(frames_):
                continue
            n = frames_.shape[1]
            if n % self.total_temporal_divisor:
                raise ValueError(f'{n} conditioning frames must divide by the total temporal '
                                 f'divisor {self.total_temporal_divisor}')
            frames_ = resize_video_to(frames_, x.shape[-2]).to(x.dtype)   # nearest, as in JAX
            if before:
                x = torch.cat((frames_, x), dim=1)
                num_preceding_frames = n
            else:
                x = torch.cat((x, frames_), dim=1)
                num_succeeding_frames = n

        if exists(cond_images):   # over every frame, the prompt frames' too
            frames_ = cond_images[:, None].expand(-1, x.shape[1], -1, -1, -1)
            frames_ = resize_video_to(frames_, x.shape[-2], method=self.resize_mode)
            x = torch.cat((frames_.to(x.dtype), x), dim=-1)

        x = spatial(self.init_conv, x)
        if not ignore_time:
            x = temporal(self.init_temporal_peg, self.init_temporal_attn, x)
        init_conv_residual = x if self.init_conv_to_final_conv_residual else None

        t, c = self._condition(
            time, lowres_noise_times=lowres_noise_times, text_embeds=text_embeds,
            text_mask=text_mask, cond_drop_prob=cond_drop_prob,
            force_text_drop_mask=force_text_drop_mask, generator=generator)

        if exists(self.init_resnet_block):
            x = self.init_resnet_block(x, t, ignore_time=ignore_time)

        hiddens = []
        for (pre, init_block, resnet_blocks, attn_block, temporal_peg, temporal_attn,
             temporal_down, post) in self.downs:
            if exists(pre):
                x = spatial(pre, x)
            x = init_block(x, t, c, ignore_time=ignore_time)
            for resnet_block in resnet_blocks:
                x = resnet_block(x, t, ignore_time=ignore_time)
                hiddens.append(x)
            if exists(attn_block):
                x = attn_block(x, context=c, generator=generator)
            if not ignore_time:
                x = temporal(temporal_peg, temporal_attn, x)
            hiddens.append(x)
            if exists(temporal_down) and not ignore_time:
                x = temporal_down(x)
            if exists(post):
                x = spatial(post, x)

        x = self.mid_block1(x, t, c, ignore_time=ignore_time)
        if exists(self.mid_attn):
            b, f, hh, ww, ch = x.shape
            x = self.mid_attn(x.reshape(b, f * hh * ww, ch)).reshape(b, f, hh, ww, ch)
        if not ignore_time:
            x = temporal(self.mid_temporal_peg, self.mid_temporal_attn, x)
        x = self.mid_block2(x, t, c, ignore_time=ignore_time)

        def add_skip(x):
            return torch.cat((x, hiddens.pop() * self.skip_connect_scale), dim=-1)

        up_hiddens = []
        for (init_block, resnet_blocks, attn_block, temporal_peg, temporal_attn, temporal_up,
             upsample) in self.ups:
            if exists(temporal_up) and not ignore_time:
                x = temporal_up(x)
            x = init_block(add_skip(x), t, c, ignore_time=ignore_time)
            for resnet_block in resnet_blocks:
                x = resnet_block(add_skip(x), t, ignore_time=ignore_time)
            if exists(attn_block):
                x = attn_block(x, context=c, generator=generator)
            if not ignore_time:
                x = temporal(temporal_peg, temporal_attn, x)
            up_hiddens.append(x)
            if exists(upsample):
                x = spatial(upsample, x)

        x = self.upsample_combiner(x, up_hiddens)
        if exists(init_conv_residual):
            x = torch.cat((x, init_conv_residual), dim=-1)
        if exists(self.final_res_block):
            x = self.final_res_block(x, t, ignore_time=ignore_time)
        if exists(lowres_cond_img):
            x = torch.cat((x, lowres_cond_img.to(x.dtype)), dim=-1)

        out = self.final_conv(x)
        return out[:, num_preceding_frames:out.shape[1] - num_succeeding_frames]
