"""The port's video blocks against the JAX package's, in fp32, to 1e-4.

Each JAX module gets seeded random params (no zero-init weight hides a path);
they reach the port module through `state_dict_from_jax`, placed where a
`Unet3D` holds that block, so the video key table and its layout
conversions are exercised too. Also: the causal temporal conv's identity
init, causality of every temporal module, and the temporal resamplers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_bridge import load_block, max_abs, randn, random_params, rng, t

from imagen_tpu.models import video_blocks as jvb
from imagen_tpu_torch.models import video_blocks as vb
from imagen_tpu_torch.utils.port_weights import state_dict_from_jax

TOL = 1e-4
B, FR, S = 2, 4, 6     # batch, frames, spatial size


def video(seed, c, b=B, f=FR, s=S):
    return randn(rng(seed), b, f, s, s, c)


def run_jax(module, params, *args, **kwargs):
    fn = jax.jit(lambda p, *a: module.apply({'params': p}, *a, **kwargs))
    return fn(jax.tree_util.tree_map(jnp.asarray, params), *map(jnp.asarray, args))


def check(jmod, tmod, flax_path, prefix, *args, seed=0, **kwargs):
    """Seeded params for `jmod`, bridged into `tmod`; both run on `args`."""
    params = random_params(jmod, *map(jnp.asarray, args), seed=seed, **kwargs)
    ref = run_jax(jmod, params, *args, **kwargs)
    load_block(tmod, params, flax_path, prefix, video=True)
    with torch.no_grad():
        out = tmod(*map(t, args), **kwargs)
    assert out.shape == ref.shape
    assert max_abs(out, ref) <= TOL
    return tmod


# --- helpers (item 2) -----------------------------------------------------------------------

@pytest.mark.parametrize('size,frames', [(12, None), (4, None), (6, 8), (9, 2)])
def test_resize_video_matches_jax(size, frames):
    x = video(1, 3)
    ref = jvb.resize_video_to(jnp.asarray(x), size, target_frames=frames)
    assert max_abs(vb.resize_video_to(t(x), size, target_frames=frames), ref) == 0.
    ref = jvb.resize_video_to(jnp.asarray(x), size, frames, clamp_range=(-0.5, 0.5))
    assert max_abs(vb.resize_video_to(t(x), size, frames, clamp_range=(-0.5, 0.5)), ref) == 0.


def test_scale_video_time_and_folding():
    x = video(2, 3, f=8)
    ref = jvb.scale_video_time(jnp.asarray(x), downsample_scale=4)
    assert max_abs(vb.scale_video_time(t(x), downsample_scale=4), ref) == 0.
    with pytest.raises(ValueError):
        vb.scale_video_time(t(x), downsample_scale=3)
    folded, b = vb.fold_frames(t(x))
    assert folded.shape == (B * 8, S, S, 3) and b == B
    assert torch.equal(vb.unfold_frames(folded, b), t(x))


# --- convolutions (item 3) ------------------------------------------------------------------

def test_pseudo_conv3d_matches_jax():
    x = video(3, 5)
    jmod = jvb.PseudoConv3d(dim_out=6)
    params = random_params(jmod, jnp.asarray(x), seed=3)
    tmod = vb.PseudoConv3d(5, 6)
    load_block(tmod, params, 'down_0_block_0/block1/project', 'downs.0.2.0.block1.project.')
    # with time, with ignore_time, and on images (both skip the temporal conv)
    for args, kwargs in (((x,), {}), ((x,), dict(ignore_time=True)), ((x[:, 0],), {})):
        ref = run_jax(jmod, params, *args, **kwargs)
        with torch.no_grad():
            assert max_abs(tmod(*map(t, args), **kwargs), ref) <= TOL


def test_pseudo_conv3d_identity_init():
    """Fresh, the temporal conv passes every frame through (delta at the last
    tap), and its weight is the JAX package's init."""
    x = t(video(4, 5))
    mod = vb.PseudoConv3d(5, 6)
    with torch.no_grad():
        assert max_abs(mod(x), mod(x, ignore_time=True)) <= 1e-6
    jmod = jvb.PseudoConv3d(dim_out=6)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(np.asarray(x)))['params']
    sd = state_dict_from_jax({'up_0_block_0': {'block2': {'project': params}}})
    assert torch.equal(sd['ups.0.1.0.block2.project.temporal_conv.weight'],
                       mod.temporal_conv.weight.detach())


def test_spatial_conv_in_3d_matches_jax():
    x = video(5, 4)
    tmod = check(jvb.SpatialConvIn3d(dim_out=7, kernel=3), vb.SpatialConvIn3d(4, 7, kernel=3),
                 'down_1_post_a', 'downs.1.7.fns.0.', x)
    assert tmod.weight.shape == (7, 4, 1, 3, 3)  # lucidrains' unit-time Conv3d


@pytest.mark.parametrize('causal', [True, False])
def test_temporal_peg_matches_jax(causal):
    tmod = check(jvb.TemporalPeg(causal=causal), vb.TemporalPeg(6, causal=causal),
                 'mid_temporal_peg', 'mid_temporal_peg.', video(6, 6))
    assert tmod.fn[1].weight.shape == (6, 1, 3, 1, 1)


# --- temporal attention (item 4) ------------------------------------------------------------

def test_dynamic_position_bias_matches_jax():
    jmod = jvb.DynamicPositionBias(dim=10, heads=3)
    params = random_params(jmod, FR + 1, seed=7)
    ref = jmod.apply({'params': jax.tree_util.tree_map(jnp.asarray, params)}, FR + 1)
    tmod = vb.DynamicPositionBias(10, 3)
    load_block(tmod, params, 'init_temporal_attn/attn/dyn_pos_bias',
               'init_temporal_attn.fn.fn.rel_pos_bias.')
    with torch.no_grad():
        out = tmod(FR + 1, torch.device('cpu'))
    assert out.shape == (3, FR + 1, FR + 1) and max_abs(out, ref) <= TOL


def test_temporal_attention_matches_jax():
    check(jvb.TemporalAttention(dim_head=4, heads=2), vb.TemporalAttention(8, dim_head=4, heads=2),
          'down_1_temporal_attn', 'downs.1.5.', video(8, 8), seed=8)


def test_flat_video_attention_matches_jax():
    """`mid_attn`: bias-free attention over (f x y) tokens, under Residual."""
    x = randn(rng(9), B, FR * S * S, 8)
    jmod = jvb.VideoAttention(dim_head=4, heads=2)
    params = random_params(jmod, jnp.asarray(x), seed=9)
    ref = run_jax(jmod, params, x) + x
    tmod = vb.Residual(vb.VideoAttention(8, dim_head=4, heads=2))
    load_block(tmod, params, 'mid_attn', 'mid_attn.', video=True)
    assert 'null_attn_bias' not in dict(tmod.named_parameters())
    with torch.no_grad():
        assert max_abs(tmod(t(x)), ref) <= TOL


@pytest.mark.parametrize('make', [
    lambda: vb.PseudoConv3d(5, 5),
    lambda: vb.TemporalPeg(5),
    lambda: vb.TemporalAttention(5, dim_head=4, heads=2),
    lambda: vb.TimeTokenShift(),
], ids=['pseudo_conv3d', 'temporal_peg', 'temporal_attention', 'time_token_shift'])
def test_temporal_modules_are_causal(make):
    """Changing the last frame leaves every earlier frame's output alone."""
    torch.manual_seed(0)
    mod = make()
    for p in mod.parameters():  # random, so no zero gain hides the attention
        p.data.normal_(0., 0.5)
    x = t(video(10, 5))
    x2 = x.clone()
    x2[:, -1] += 1.
    with torch.no_grad():
        a, b = mod(x), mod(x2)
    assert torch.equal(a[:, :-1], b[:, :-1])
    assert not torch.equal(a[:, -1], b[:, -1])


# --- feedforward and blocks (items 5, 6) ----------------------------------------------------

def test_time_token_shift_matches_jax():
    x = video(11, 6)
    ref = jvb.TimeTokenShift().apply({}, jnp.asarray(x))
    assert max_abs(vb.TimeTokenShift()(t(x)), ref) == 0.


@pytest.mark.parametrize('shift', [True, False])
def test_chan_feedforward_video_matches_jax(shift):
    tmod = check(jvb.ChanFeedForwardVideo(mult=2., time_token_shift=shift),
                 vb.ChanFeedForwardVideo(6, mult=2., time_token_shift=shift),
                 'down_0_attn/ff_0', 'downs.0.3.layers.0.1.', video(12, 6), seed=12)
    assert tmod[0].g.shape == (1, 6, 1, 1, 1) and tmod[1].weight.shape == (12, 6, 1, 1, 1)


def test_block_video_matches_jax():
    check(jvb.BlockVideo(dim_out=7), vb.BlockVideo(5, 7), 'down_0_block_0/block1',
          'downs.0.2.0.block1.', video(13, 5), seed=13)


@pytest.mark.parametrize('cross,gca,dim_out', [(True, False, 8), (False, True, 6)])
def test_resnet_block_video_matches_jax(cross, gca, dim_out):
    x, time_emb = video(14, 6), randn(rng(15), B, 16)
    cond = randn(rng(16), B, 5, 8)
    jmod = jvb.ResnetBlockVideo(dim_out=dim_out, cond_dim=8 if cross else None,
                                time_cond_dim=16, use_gca=gca, attn_dim_head=4, attn_heads=2)
    tmod = vb.ResnetBlockVideo(6, dim_out, cond_dim=8 if cross else None, time_cond_dim=16,
                               use_gca=gca, attn_dim_head=4, attn_heads=2)
    args = (x, time_emb, cond) if cross else (x, time_emb)
    check(jmod, tmod, 'up_1_block_0', 'ups.1.1.0.', *args, seed=17)


def test_transformer_block_video_matches_jax():
    x, ctx = video(18, 8), randn(rng(19), B, 5, 8)
    check(jvb.TransformerBlockVideo(heads=2, dim_head=4, context_dim=8),
          vb.TransformerBlockVideo(8, heads=2, dim_head=4, context_dim=8),
          'down_1_attn', 'downs.1.3.', x, ctx, seed=20)


def test_linear_attention_block_is_not_ported():
    """The block that used to raise here is ported
    (`test_torch_linear_attention.py` holds it to JAX): it builds with
    lucidrains' video shapes and keeps the clip's shape."""
    block = vb.LinearAttentionTransformerBlockVideo(8, heads=2, dim_head=4)
    shapes = {k: tuple(v.shape) for k, v in block.state_dict().items()}
    assert shapes['layers.0.0.to_q.2.weight'] == (8, 1, 1, 3, 3)
    assert shapes['layers.0.0.norm.g'] == (1, 8, 1, 1, 1)
    x = torch.randn(2, 3, 4, 4, 8)
    assert block.eval()(x).shape == x.shape


# --- temporal resolution (item 7) -----------------------------------------------------------

def test_temporal_pixel_shuffle_upsample_matches_jax():
    tmod = check(jvb.TemporalPixelShuffleUpsample(dim_out=6, stride=2),
                 vb.TemporalPixelShuffleUpsample(6, 6, stride=2),
                 'up_0_temporal_up', 'ups.0.5.', video(21, 6, f=2), seed=21)
    out = tmod(t(video(22, 6, f=2)))
    assert out.shape == (B, 4, S, S, 6)
    # fresh, the stride copies of each output channel start equal
    fresh = vb.TemporalPixelShuffleUpsample(6, 6, stride=2).conv.weight
    assert torch.equal(fresh[0::2], fresh[1::2])


def test_temporal_downsample_matches_jax():
    tmod = check(jvb.TemporalDownsample(dim_out=6, stride=2), vb.TemporalDownsample(6, 6, stride=2),
                 'down_0_temporal_down', 'downs.0.6.', video(23, 6), seed=23)
    assert tmod(t(video(24, 6))).shape == (B, FR // 2, S, S, 6)


def test_upsample_combiner_video_matches_jax():
    x = video(25, 8, s=8)
    fmaps = (video(26, 6, s=4), video(27, 4, s=8))
    jmod = jvb.UpsampleCombinerVideo(dim=8, enabled=True, dim_ins=(6, 4), dim_outs=(8, 8))
    params = random_params(jmod, jnp.asarray(x), tuple(map(jnp.asarray, fmaps)), seed=28)
    ref = jmod.apply({'params': jax.tree_util.tree_map(jnp.asarray, params)}, jnp.asarray(x),
                     tuple(map(jnp.asarray, fmaps)))
    tmod = vb.UpsampleCombinerVideo(8, enabled=True, dim_ins=(6, 4), dim_outs=(8, 8))
    load_block(tmod, params, 'upsample_combiner', 'upsample_combiner.')
    with torch.no_grad():
        out = tmod(t(x), tuple(map(t, fmaps)))
    assert out.shape == (B, FR, 8, 8, 24) and max_abs(out, ref) <= TOL
