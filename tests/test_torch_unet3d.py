"""The port's `Unet3D` against the JAX package's, in fp32, to 1e-4.

At the tiny size of `tests/test_unet3d.py` (dim 8, two levels, 2 heads of
4): the plain forward, temporal strides with low-res conditioning,
preceding and succeeding prompt frames, `ignore_time`, and a spatial
transformer level. Seeded random weights go through `state_dict_from_jax`,
which must give exactly the port's parameters: every JAX leaf is used once
and every port parameter is given, at its own shape.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_bridge import jparams, load_into, max_abs, randn, random_params, rng, t

from imagen_tpu.models.unet3d import Unet3D as JUnet3D

import imagen_tpu_torch as it
from imagen_tpu_torch.utils.port_weights import state_dict_from_jax

TINY = dict(dim=8, dim_mults=(1, 2), text_embed_dim=16, cond_dim=8, attn_dim_head=4,
            attn_heads=2, attn_pool_num_latents=2, max_text_len=8, layer_attns=False,
            layer_cross_attns=(False, True))
B, FR, S = 2, 4, 8

CASES = {
    'plain': ({}, {}),
    'strides_lowres': (dict(temporal_strides=(1, 2), lowres_cond=True), {}),
    'prompt_frames': ({}, dict(cond_video_frames=2, post_cond_video_frames=2)),
    'ignore_time': ({}, dict(ignore_time=True)),
    'transformer': (dict(layer_attns=(False, True)), {}),
}


def _inputs(cfg, call, seed):
    r = rng(seed)
    x = randn(r, B, FR, S, S, 3)
    kw = dict(text_embeds=randn(r, B, 6, 16), text_mask=np.ones((B, 6), bool))
    kw['text_mask'][0, 4:] = False
    if cfg.get('lowres_cond'):
        kw.update(lowres_cond_img=randn(r, B, FR, S, S, 3),
                  lowres_noise_times=r.rand(B).astype(np.float32))
    for name in ('cond_video_frames', 'post_cond_video_frames'):
        if name in call:
            kw[name] = r.rand(B, call[name], S, S, 3).astype(np.float32)
    return x, r.rand(B).astype(np.float32), kw


@pytest.mark.parametrize('case', list(CASES))
def test_unet3d_matches_jax(case):
    extra, call = CASES[case]
    cfg = {**TINY, **extra}
    ignore_time = call.get('ignore_time', False)
    x, time, kw = _inputs(cfg, call, seed=len(case))
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    junet = JUnet3D(**cfg)
    params = random_params(junet, jnp.asarray(x), jnp.asarray(time), seed=40, **jkw)
    ref = jax.jit(lambda v, x, tm, kw: junet.apply(v, x, tm, ignore_time=ignore_time, **kw))(
        jparams(params), jnp.asarray(x), jnp.asarray(time), jkw)

    unet = load_into(it.Unet3D(**cfg, device='cpu'), params)
    with torch.no_grad():
        out = unet(t(x), t(time), ignore_time=ignore_time, **{k: t(v) for k, v in kw.items()})
    assert out.shape == (B, FR, S, S, 3)
    assert max_abs(out, ref) <= 1e-4


@pytest.mark.parametrize('extra', [{}, dict(temporal_strides=(2, 1), memory_efficient=True,
                                            init_cross_embed=False)],
                         ids=['bench_like', 'strides_memory_efficient'])
def test_weights_bridge_is_strict_both_ways(extra):
    cfg = {**TINY, **extra}
    x, time, kw = _inputs(cfg, {}, seed=1)
    junet = JUnet3D(**cfg)
    shapes = jax.eval_shape(lambda: junet.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(time),
        **{k: jnp.asarray(v) for k, v in kw.items()}))['params']
    leaves = jax.tree_util.tree_leaves(shapes)
    sd = state_dict_from_jax(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                                    shapes))
    mine = it.Unet3D(**cfg, device='cpu').state_dict()
    assert len(sd) == len(leaves)
    assert set(sd) == set(mine)
    for key, value in sd.items():
        assert value.shape == mine[key].shape, key
    # lucidrains' shapes: unit-time Conv3d, 1x1x1 Conv3d, depthwise PEG, Conv1d
    assert mine['final_conv.weight'].shape == (3, 8, 1, 3, 3)
    assert mine['downs.0.1.block1.project.temporal_conv.weight'].shape[-1] == 3
    assert mine['init_temporal_peg.fn.1.weight'].shape == (8, 1, 3, 1, 1)
    assert 'mid_attn.fn.null_attn_bias' not in mine
    if extra:
        assert mine['downs.0.6.conv.weight'].ndim == 3
        assert mine['downs.0.0.1.weight'].ndim == 5        # pre-downsample, 1x1x1
        assert 'init_resnet_block.block1.norm.gamma' in mine


def test_unet3d_cast_and_checks():
    unet = it.Unet3D(**TINY, device='cpu')
    assert unet.cast_model_parameters(lowres_cond=False, text_embed_dim=16, channels=3,
                                      channels_out=None, cond_on_text=True) is unet
    sr = unet.cast_model_parameters(lowres_cond=True, text_embed_dim=16, channels=3,
                                    channels_out=None, cond_on_text=True)
    assert sr.lowres_cond and isinstance(sr, it.Unet3D)
    # the options that used to raise here build (test_torch_unet_options.py and
    # test_torch_remat.py hold them to JAX); an unknown resize method raises
    for ported in (dict(remat=True), dict(dropout=0.1), dict(use_linear_attn=True)):
        it.Unet3D(**TINY, **ported, device='cpu')
    with pytest.raises(ValueError):
        it.Unet3D(**TINY, resize_mode='area', device='cpu')
    with pytest.raises(ValueError):  # 3 frames, temporal divisor 2
        it.Unet3D(**TINY, temporal_strides=(2, 1), device='cpu')(
            torch.zeros(1, 3, S, S, 3), torch.zeros(1))


def test_unet3d_without_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip('a GPU is present')
    with pytest.raises(RuntimeError):
        it.Unet3D(**TINY)
