"""Key tables: a JAX package param path -> lucidrains' `state_dict` key.

The port's own copy of the tables in `tools/port_weights.py` (`ref_key_for`,
2D `Unet`) and `tools/port_weights_video.py` (`ref_key_for_video`,
`Unet3D`), so that the port imports nothing of the JAX side's tooling. The
video table differs from its original where the original cannot have been
exercised:

- `down_{i}_temporal_down` and `up_{i}_temporal_up` (the names `Unet3D`
  gives its temporal resamplers; the original spelled them `..._downsample`
  and `..._upsample`, so `temporal_strides > 1` found no key);
- `init_resnet_block` (`memory_efficient=True`) and `init_conv/conv`
  (`init_cross_embed=False`), which the original did not map;
- the linear attention of `LinearAttentionTransformerBlockVideo` and the
  cross-embed downsample (`down_{i}_pre/conv_{j}`, `down_{i}_post/conv_{j}`),
  which the original does not have: named here after the 2D keys, and not
  checked against a lucidrains `Unet3D` checkpoint.
"""
from __future__ import annotations

import re


def _wb(leaf):
    return 'weight' if leaf == 'kernel' else 'bias'


# --- 2D ------------------------------------------------------------------------------------

def _ff(rest):
    """FeedForward: Sequential(LayerNorm, Linear, GELU, LayerNorm, Linear) -> 0,1,3,4."""
    return {
        'LayerNorm_0/g': '0.g',
        'Dense_0/kernel': '1.weight',
        'LayerNorm_1/g': '3.g',
        'Dense_1/kernel': '4.weight',
    }[rest]


def _cross_attn(rest):
    """CrossAttention."""
    return {
        'LayerNorm_0/g': 'norm.g',
        'to_q/kernel': 'to_q.weight',
        'to_kv/kernel': 'to_kv.weight',
        'null_kv': 'null_kv',
        'q_scale': 'q_scale',
        'k_scale': 'k_scale',
        'to_out/kernel': 'to_out.0.weight',
        'out_norm/g': 'to_out.1.g',
    }[rest]


def _self_attn(rest):
    """Attention (multi-query): CrossAttention's names plus the to_context branch."""
    table = {
        'ctx_norm/LayerNorm_0/scale': 'to_context.0.weight',
        'ctx_norm/LayerNorm_0/bias': 'to_context.0.bias',
        'to_context/kernel': 'to_context.1.weight',
        'to_context/bias': 'to_context.1.bias',
    }
    if rest in table:
        return table[rest]
    return _cross_attn(rest)


def _linear_attn(rest):
    """LinearAttention: the q, k and v stacks (Dropout, 1x1 conv, depthwise
    3x3 conv), the context projection and the output conv and norm."""
    m = re.fullmatch(r'to_([qkv])_(proj|dw)/kernel', rest)
    if m:
        return f'to_{m.group(1)}.{1 if m.group(2) == "proj" else 2}.weight'
    return {
        'LayerNorm_0/g': 'norm.g',
        'ctx_norm/LayerNorm_0/scale': 'to_context.0.weight',
        'ctx_norm/LayerNorm_0/bias': 'to_context.0.bias',
        'to_context/kernel': 'to_context.1.weight',
        'to_out/kernel': 'to_out.0.weight',
        'out_norm/g': 'to_out.1.g',
    }[rest]


def _any_attn(rest, table):
    """`table`'s key, or the LinearAttention key of a linear block's sublayer."""
    try:
        return table(rest)
    except KeyError:
        return _linear_attn(rest)


def _transformer(rest):
    """TransformerBlock or LinearAttentionTransformerBlock:
    layers.{d}.(0: attention | 1: feedforward)."""
    m = re.fullmatch(r'attn_(\d+)/(.*)', rest)
    if m:
        return f'layers.{m.group(1)}.0.' + _any_attn(m.group(2), _self_attn)
    m = re.fullmatch(r'ff_(\d+)/(.*)', rest)
    if m:
        return f'layers.{m.group(1)}.1.' + _ff(m.group(2))
    raise KeyError(rest)


def _block(rest):
    """Block: ChanRMSNorm + project conv."""
    return {
        'ChanRMSNorm_0/gamma': 'norm.gamma',
        'project/kernel': 'project.weight',
        'project/bias': 'project.bias',
    }[rest]


def _gca(rest):
    """GlobalContext."""
    return {
        'to_k/kernel': 'to_k.weight',
        'to_k/bias': 'to_k.bias',
        'Dense_0/kernel': 'net.0.weight',
        'Dense_0/bias': 'net.0.bias',
        'Dense_1/kernel': 'net.2.weight',
        'Dense_1/bias': 'net.2.bias',
    }[rest]


def _resnet(rest):
    """ResnetBlock."""
    m = re.fullmatch(r'time_mlp/(kernel|bias)', rest)
    if m:
        return f'time_mlp.1.{_wb(m.group(1))}'
    m = re.fullmatch(r'(block[12])/(.*)', rest)
    if m:
        return f'{m.group(1)}.' + _block(m.group(2))
    m = re.fullmatch(r'cross_attn/(.*)', rest)
    if m:
        return 'cross_attn.' + _cross_attn(m.group(1))
    m = re.fullmatch(r'gca/(.*)', rest)
    if m:
        return 'gca.' + _gca(m.group(1))
    m = re.fullmatch(r'res_conv/(kernel|bias)', rest)
    if m:
        return f'res_conv.{_wb(m.group(1))}'
    raise KeyError(rest)


def _perceiver_attn(rest):
    """PerceiverAttention: torch LayerNorms with weight and bias."""
    return {
        'norm/LayerNorm_0/scale': 'norm.weight',
        'norm/LayerNorm_0/bias': 'norm.bias',
        'norm_latents/LayerNorm_0/scale': 'norm_latents.weight',
        'norm_latents/LayerNorm_0/bias': 'norm_latents.bias',
        'to_q/kernel': 'to_q.weight',
        'to_kv/kernel': 'to_kv.weight',
        'q_scale': 'q_scale',
        'k_scale': 'k_scale',
        'to_out/kernel': 'to_out.0.weight',
        'out_norm/LayerNorm_0/scale': 'to_out.1.weight',
        'out_norm/LayerNorm_0/bias': 'to_out.1.bias',
    }[rest]


def _conditioning(path):
    """Time and text conditioning heads and the attention pool, which the 2D
    and video U-Nets name alike; None for any other path."""
    m = re.fullmatch(r'(to_time|to_lowres_time)_sinu/weights', path)
    if m:
        return f'{m.group(1)}_hiddens.0.weights'
    m = re.fullmatch(r'(to_time|to_lowres_time)_(hiddens)/(kernel|bias)', path)
    if m:
        return f'{m.group(1)}_hiddens.1.{_wb(m.group(3))}'
    m = re.fullmatch(r'(to_time|to_lowres_time)_(tokens|cond)/(kernel|bias)', path)
    if m:
        return f'{m.group(1)}_{m.group(2)}.0.{_wb(m.group(3))}'
    m = re.fullmatch(r'text_to_cond/(kernel|bias)', path)
    if m:
        return f'text_to_cond.{_wb(m.group(1))}'
    if path in ('null_text_embed', 'null_text_hidden'):
        return path
    m = re.fullmatch(r'text_hidden_norm/LayerNorm_0/(scale|bias)', path)
    if m:
        return 'to_text_non_attn_cond.0.' + ('weight' if m.group(1) == 'scale' else 'bias')
    m = re.fullmatch(r'text_hidden_proj([12])/(kernel|bias)', path)
    if m:
        idx = '1' if m.group(1) == '1' else '3'
        return f'to_text_non_attn_cond.{idx}.{_wb(m.group(2))}'
    m = re.fullmatch(r'norm_cond/LayerNorm_0/(scale|bias)', path)
    if m:
        return 'norm_cond.' + ('weight' if m.group(1) == 'scale' else 'bias')

    if path == 'attn_pool/latents':
        return 'attn_pool.latents'
    if path == 'attn_pool/pos_emb/embedding':
        return 'attn_pool.pos_emb.weight'
    if path == 'attn_pool/mp_norm/g':
        return 'attn_pool.to_latents_from_mean_pooled_seq.0.g'
    m = re.fullmatch(r'attn_pool/mp_proj/(kernel|bias)', path)
    if m:
        return f'attn_pool.to_latents_from_mean_pooled_seq.1.{_wb(m.group(1))}'
    m = re.fullmatch(r'attn_pool/attn_(\d+)/(.*)', path)
    if m:
        return f'attn_pool.layers.{m.group(1)}.0.' + _perceiver_attn(m.group(2))
    m = re.fullmatch(r'attn_pool/ff_(\d+)/(.*)', path)
    if m:
        return f'attn_pool.layers.{m.group(1)}.1.' + _ff(m.group(2))
    return None


def ref_key_for(path: str) -> str:
    """The 2D `Unet`'s key for a '/'-joined JAX param path."""
    key = _conditioning(path)
    if key is not None:
        return key

    m = re.fullmatch(r'init_conv/conv_(\d+)/(kernel|bias)', path)
    if m:
        return f'init_conv.convs.{m.group(1)}.{_wb(m.group(2))}'
    m = re.fullmatch(r'init_conv/(kernel|bias)', path)
    if m:
        return f'init_conv.{_wb(m.group(1))}'

    # down path: 0 pre-downsample, 1 init block, 2 resnets, 3 transformer, 4 post-downsample
    m = re.fullmatch(r'init_resnet_block/(.*)', path)
    if m:
        return 'init_resnet_block.' + _resnet(m.group(1))
    m = re.fullmatch(r'down_(\d+)_pre/conv/(kernel|bias)', path)
    if m:
        return f'downs.{m.group(1)}.0.1.{_wb(m.group(2))}'
    m = re.fullmatch(r'down_(\d+)_(pre|post)/conv_(\d+)/(kernel|bias)', path)
    if m:   # cross-embed downsample
        slot = 0 if m.group(2) == 'pre' else 4
        return f'downs.{m.group(1)}.{slot}.convs.{m.group(3)}.{_wb(m.group(4))}'
    m = re.fullmatch(r'down_(\d+)_init_block/(.*)', path)
    if m:
        return f'downs.{m.group(1)}.1.' + _resnet(m.group(2))
    m = re.fullmatch(r'down_(\d+)_block_(\d+)/(.*)', path)
    if m:
        return f'downs.{m.group(1)}.2.{m.group(2)}.' + _resnet(m.group(3))
    m = re.fullmatch(r'down_(\d+)_attn/(.*)', path)
    if m:
        return f'downs.{m.group(1)}.3.' + _transformer(m.group(2))
    m = re.fullmatch(r'down_(\d+)_post_a/(kernel|bias)', path)
    if m:
        return f'downs.{m.group(1)}.4.fns.0.{_wb(m.group(2))}'
    m = re.fullmatch(r'down_(\d+)_post_b/(kernel|bias)', path)
    if m:
        return f'downs.{m.group(1)}.4.fns.1.{_wb(m.group(2))}'
    m = re.fullmatch(r'down_(\d+)_post/conv/(kernel|bias)', path)
    if m:
        return f'downs.{m.group(1)}.4.1.{_wb(m.group(2))}'

    m = re.fullmatch(r'(mid_block[12]|final_res_block)/(.*)', path)
    if m:
        return f'{m.group(1)}.' + _resnet(m.group(2))
    m = re.fullmatch(r'mid_attn/(.*)', path)
    if m:
        return 'mid_attn.' + _transformer(m.group(1))

    # up path: 0 init block, 1 resnets, 2 transformer, 3 upsample
    m = re.fullmatch(r'up_(\d+)_init_block/(.*)', path)
    if m:
        return f'ups.{m.group(1)}.0.' + _resnet(m.group(2))
    m = re.fullmatch(r'up_(\d+)_block_(\d+)/(.*)', path)
    if m:
        return f'ups.{m.group(1)}.1.{m.group(2)}.' + _resnet(m.group(3))
    m = re.fullmatch(r'up_(\d+)_attn/(.*)', path)
    if m:
        return f'ups.{m.group(1)}.2.' + _transformer(m.group(2))
    m = re.fullmatch(r'up_(\d+)_upsample/conv/(kernel|bias)', path)
    if m:  # PixelShuffleUpsample: Sequential 'net', conv at 0
        return f'ups.{m.group(1)}.3.net.0.{_wb(m.group(2))}'
    m = re.fullmatch(r'up_(\d+)_upsample/Conv_0/(kernel|bias)', path)
    if m:  # Upsample: Sequential(nearest x2, conv)
        return f'ups.{m.group(1)}.3.1.{_wb(m.group(2))}'

    m = re.fullmatch(r'upsample_combiner/fmap_conv_(\d+)/(.*)', path)
    if m:
        return f'upsample_combiner.fmap_convs.{m.group(1)}.' + _block(m.group(2))
    m = re.fullmatch(r'final_conv/(kernel|bias)', path)
    if m:
        return f'final_conv.{_wb(m.group(1))}'
    raise KeyError(f'no key for JAX param path {path!r}')


# --- video ---------------------------------------------------------------------------------

def _ff_chan_video(rest):
    """Video ChanFeedForward: Sequential(ChanLayerNorm, Conv, GELU, TimeTokenShift,
    ChanLayerNorm, Conv) -> 0,1,4,5."""
    return {
        'LayerNorm_0/g': '0.g',
        'Dense_0/kernel': '1.weight',
        'LayerNorm_1/g': '4.g',
        'Dense_1/kernel': '5.weight',
    }[rest]


def _video_attn(rest):
    """Video Attention: the 2D attention's names plus null_attn_bias and the
    zero-init out-norm gain."""
    table = {
        'ctx_norm/LayerNorm_0/scale': 'to_context.0.weight',
        'ctx_norm/LayerNorm_0/bias': 'to_context.0.bias',
        'to_context/kernel': 'to_context.1.weight',
        'to_context/bias': 'to_context.1.bias',
        'null_attn_bias': 'null_attn_bias',
        'out_norm_g': 'to_out.1.g',
    }
    if rest in table:
        return table[rest]
    return _cross_attn(rest)


def _temporal_attn(rest):
    """VideoAttention under TemporalAttention, with its DynamicPositionBias MLP
    (depth 2: in, one hidden, out)."""
    table = {
        'dyn_pos_bias/mlp_in/kernel': 'rel_pos_bias.mlp.0.0.weight',
        'dyn_pos_bias/mlp_in/bias': 'rel_pos_bias.mlp.0.0.bias',
        'dyn_pos_bias/norm_in/g': 'rel_pos_bias.mlp.0.1.g',
        'dyn_pos_bias/mlp_0/kernel': 'rel_pos_bias.mlp.1.0.weight',
        'dyn_pos_bias/mlp_0/bias': 'rel_pos_bias.mlp.1.0.bias',
        'dyn_pos_bias/norm_0/g': 'rel_pos_bias.mlp.1.1.g',
        'dyn_pos_bias/mlp_out/kernel': 'rel_pos_bias.mlp.2.weight',
        'dyn_pos_bias/mlp_out/bias': 'rel_pos_bias.mlp.2.bias',
    }
    if rest in table:
        return table[rest]
    return _video_attn(rest)


def _transformer_video(rest):
    """TransformerBlockVideo or LinearAttentionTransformerBlockVideo:
    layers.{d}.(0: attention | 1: chan FF with token shift)."""
    m = re.fullmatch(r'attn_(\d+)/(.*)', rest)
    if m:
        return f'layers.{m.group(1)}.0.' + _any_attn(m.group(2), _video_attn)
    m = re.fullmatch(r'ff_(\d+)/(.*)', rest)
    if m:
        return f'layers.{m.group(1)}.1.' + _ff_chan_video(m.group(2))
    raise KeyError(rest)


def _block_video(rest):
    """Video Block: ChanRMSNorm + PseudoConv3d (spatial and temporal convs)."""
    return {
        'ChanRMSNorm_0/gamma': 'norm.gamma',
        'project/spatial_conv/kernel': 'project.spatial_conv.weight',
        'project/spatial_conv/bias': 'project.spatial_conv.bias',
        'project/temporal_conv/kernel': 'project.temporal_conv.weight',
        'project/temporal_conv/bias': 'project.temporal_conv.bias',
    }[rest]


def _resnet_video(rest):
    m = re.fullmatch(r'time_mlp/(kernel|bias)', rest)
    if m:
        return f'time_mlp.1.{_wb(m.group(1))}'
    m = re.fullmatch(r'(block[12])/(.*)', rest)
    if m:
        return f'{m.group(1)}.' + _block_video(m.group(2))
    m = re.fullmatch(r'cross_attn/(.*)', rest)
    if m:
        return 'cross_attn.' + _cross_attn(m.group(1))
    m = re.fullmatch(r'gca/(.*)', rest)
    if m:
        return 'gca.' + _gca(m.group(1))
    m = re.fullmatch(r'res_conv/(kernel|bias)', rest)
    if m:
        return f'res_conv.{_wb(m.group(1))}'
    raise KeyError(rest)


def ref_key_for_video(path: str) -> str:
    """The `Unet3D`'s key for a '/'-joined JAX param path. Residual and
    time-centric wrappers add the `.fn` segments."""
    key = _conditioning(path)
    if key is not None:
        return key

    m = re.fullmatch(r'init_conv/conv_(\d+)/(kernel|bias)', path)
    if m:
        return f'init_conv.convs.{m.group(1)}.{_wb(m.group(2))}'
    m = re.fullmatch(r'init_conv/conv/(kernel|bias)', path)
    if m:
        return f'init_conv.{_wb(m.group(1))}'
    m = re.fullmatch(r'init_temporal_peg/conv/(kernel|bias)', path)
    if m:
        return f'init_temporal_peg.fn.1.{_wb(m.group(1))}'
    m = re.fullmatch(r'init_temporal_attn/attn/(.*)', path)
    if m:
        return 'init_temporal_attn.fn.fn.' + _temporal_attn(m.group(1))
    m = re.fullmatch(r'init_resnet_block/(.*)', path)
    if m:
        return 'init_resnet_block.' + _resnet_video(m.group(1))

    # down path: 0 pre-downsample, 1 init resnet, 2 resnets, 3 transformer,
    # 4 temporal peg, 5 temporal attention, 6 temporal downsample, 7 post-downsample
    m = re.fullmatch(r'down_(\d+)_pre/conv/(kernel|bias)', path)
    if m:
        return f'downs.{m.group(1)}.0.1.{_wb(m.group(2))}'
    m = re.fullmatch(r'down_(\d+)_(pre|post)/conv_(\d+)/(kernel|bias)', path)
    if m:   # cross-embed downsample
        slot = 0 if m.group(2) == 'pre' else 7
        return f'downs.{m.group(1)}.{slot}.convs.{m.group(3)}.{_wb(m.group(4))}'
    m = re.fullmatch(r'down_(\d+)_init_block/(.*)', path)
    if m:
        return f'downs.{m.group(1)}.1.' + _resnet_video(m.group(2))
    m = re.fullmatch(r'down_(\d+)_block_(\d+)/(.*)', path)
    if m:
        return f'downs.{m.group(1)}.2.{m.group(2)}.' + _resnet_video(m.group(3))
    m = re.fullmatch(r'down_(\d+)_attn/(.*)', path)
    if m:
        return f'downs.{m.group(1)}.3.' + _transformer_video(m.group(2))
    m = re.fullmatch(r'down_(\d+)_temporal_peg/conv/(kernel|bias)', path)
    if m:
        return f'downs.{m.group(1)}.4.fn.1.{_wb(m.group(2))}'
    m = re.fullmatch(r'down_(\d+)_temporal_attn/attn/(.*)', path)
    if m:
        return f'downs.{m.group(1)}.5.fn.fn.' + _temporal_attn(m.group(2))
    m = re.fullmatch(r'down_(\d+)_temporal_down/conv/(kernel|bias)', path)
    if m:
        return f'downs.{m.group(1)}.6.conv.{_wb(m.group(2))}'
    m = re.fullmatch(r'down_(\d+)_post/conv/(kernel|bias)', path)
    if m:
        return f'downs.{m.group(1)}.7.1.{_wb(m.group(2))}'
    m = re.fullmatch(r'down_(\d+)_post_a/conv/(kernel|bias)', path)
    if m:
        return f'downs.{m.group(1)}.7.fns.0.{_wb(m.group(2))}'
    m = re.fullmatch(r'down_(\d+)_post_b/(kernel|bias)', path)
    if m:
        return f'downs.{m.group(1)}.7.fns.1.{_wb(m.group(2))}'

    m = re.fullmatch(r'(mid_block[12]|final_res_block)/(.*)', path)
    if m:
        return f'{m.group(1)}.' + _resnet_video(m.group(2))
    m = re.fullmatch(r'mid_attn/(.*)', path)
    if m:
        return 'mid_attn.fn.' + _video_attn(m.group(1))
    m = re.fullmatch(r'mid_temporal_peg/conv/(kernel|bias)', path)
    if m:
        return f'mid_temporal_peg.fn.1.{_wb(m.group(1))}'
    m = re.fullmatch(r'mid_temporal_attn/attn/(.*)', path)
    if m:
        return 'mid_temporal_attn.fn.fn.' + _temporal_attn(m.group(1))

    # up path: 0 init resnet, 1 resnets, 2 transformer, 3 temporal peg,
    # 4 temporal attention, 5 temporal upsample, 6 upsample
    m = re.fullmatch(r'up_(\d+)_init_block/(.*)', path)
    if m:
        return f'ups.{m.group(1)}.0.' + _resnet_video(m.group(2))
    m = re.fullmatch(r'up_(\d+)_block_(\d+)/(.*)', path)
    if m:
        return f'ups.{m.group(1)}.1.{m.group(2)}.' + _resnet_video(m.group(3))
    m = re.fullmatch(r'up_(\d+)_attn/(.*)', path)
    if m:
        return f'ups.{m.group(1)}.2.' + _transformer_video(m.group(2))
    m = re.fullmatch(r'up_(\d+)_temporal_peg/conv/(kernel|bias)', path)
    if m:
        return f'ups.{m.group(1)}.3.fn.1.{_wb(m.group(2))}'
    m = re.fullmatch(r'up_(\d+)_temporal_attn/attn/(.*)', path)
    if m:
        return f'ups.{m.group(1)}.4.fn.fn.' + _temporal_attn(m.group(2))
    m = re.fullmatch(r'up_(\d+)_temporal_up/conv/(kernel|bias)', path)
    if m:
        return f'ups.{m.group(1)}.5.conv.{_wb(m.group(2))}'
    m = re.fullmatch(r'up_(\d+)_upsample/conv/(kernel|bias)', path)
    if m:
        return f'ups.{m.group(1)}.6.net.0.{_wb(m.group(2))}'
    m = re.fullmatch(r'up_(\d+)_upsample/Conv_0/(kernel|bias)', path)
    if m:
        return f'ups.{m.group(1)}.6.1.{_wb(m.group(2))}'

    m = re.fullmatch(r'upsample_combiner/fmap_conv_(\d+)/(.*)', path)
    if m:
        return f'upsample_combiner.fmap_convs.{m.group(1)}.' + _block_video(m.group(2))
    m = re.fullmatch(r'final_conv/(kernel|bias)', path)
    if m:
        return f'final_conv.{_wb(m.group(1))}'
    raise KeyError(f'no key for JAX param path {path!r}')
