"""The port's math, attention and kernel-holding blocks against the JAX package.

Same seeded numpy inputs and bridged weights on both sides, fp32, on the
CPU (where each kernel wrapper runs its plain version). Modules are held to
1e-4; the diffusion math to the closed forms of tests/test_diffusion_math.py
and to the JAX functions.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_bridge import (
    jparams, load_block, max_abs, np_, randn, random_params, rng, t)

import imagen_tpu.models.blocks as jb
import imagen_tpu.ops.attention as jattn
from imagen_tpu.diffusion.imagen import Imagen as JImagen
from imagen_tpu.models.unet2d import Unet as JUnet
from imagen_tpu.ops.diffusion_math import GaussianDiffusionContinuousTimes as JSched

import imagen_tpu_torch as it
from imagen_tpu_torch.models import blocks
from imagen_tpu_torch.ops import attention, conv2d, flash_attention, fused_norm
from imagen_tpu_torch.ops.diffusion_math import (
    GaussianDiffusionContinuousTimes,
    alpha_cosine_log_snr,
    beta_linear_log_snr,
    log_snr_to_alpha_sigma,
)
from imagen_tpu_torch.ops.tensor_utils import quantile_rows

TOL = 1e-4


# --- tensor_utils: the dynamic-thresholding percentile --------------------------------------

@pytest.mark.parametrize('pct', [0.95, 0.9, 0.995])
def test_threshold_x_start_matches_jax(pct):
    tiny = dict(dim=8, dim_mults=(1, 2), text_embed_dim=16, cond_dim=8, attn_dim_head=4,
                attn_heads=2, attn_pool_num_latents=2, max_text_len=8, layer_attns=False,
                layer_cross_attns=(False, True))
    jimagen = JImagen(unets=(JUnet(**tiny),), image_sizes=(16,), text_embed_dim=16,
                      timesteps=4, dynamic_thresholding_percentile=pct)
    timagen = it.Imagen(it.Unet(**tiny, device='cpu'), image_sizes=(16,), text_embed_dim=16,
                        timesteps=4, dynamic_thresholding_percentile=pct, device='cpu')
    x = randn(rng(0), 3, 16, 16, 3, scale=2.5)
    ref = jimagen.threshold_x_start(jnp.asarray(x), True)
    assert max_abs(timagen.threshold_x_start(t(x), True), ref) <= 1e-6
    # the percentile is torch.quantile's (whose lerp may round one ulp apart)
    flat = t(np.abs(x).reshape(3, -1))
    np.testing.assert_allclose(np_(quantile_rows(flat, pct)),
                               np_(torch.quantile(flat, pct, dim=-1)), rtol=1e-6, atol=0)


# --- diffusion_math -------------------------------------------------------------------------

def test_log_snr_closed_forms():
    tt = np.linspace(0., 1., 11)
    np.testing.assert_allclose(np_(beta_linear_log_snr(torch.tensor(tt))),
                               -np.log(np.expm1(1e-4 + 10 * tt ** 2)), rtol=1e-4, atol=1e-4)
    s, tt = 0.008, np.linspace(0., 0.98, 11)
    inner = np.clip(np.cos((tt + s) / (1 + s) * math.pi / 2) ** -2 - 1, 1e-5, None)
    np.testing.assert_allclose(np_(alpha_cosine_log_snr(torch.tensor(tt))), -np.log(inner),
                               rtol=1e-3, atol=1e-4)
    alpha, sigma = log_snr_to_alpha_sigma(torch.linspace(-20, 20, 41))
    np.testing.assert_allclose(np_(alpha ** 2 + sigma ** 2), 1., atol=1e-6)


@pytest.mark.parametrize('schedule', ['linear', 'cosine'])
def test_diffusion_math_matches_jax(schedule):
    r = rng(1)
    x0, noise, x_t = (randn(r, 2, 8, 8, 3) for _ in range(3))
    tt = np.asarray([0.8, 0.3], np.float32)
    tn = np.asarray([0.7, 0.0], np.float32)
    js, ts = JSched(noise_schedule=schedule, timesteps=10), \
        GaussianDiffusionContinuousTimes(noise_schedule=schedule, timesteps=10)
    jx = tuple(map(jnp.asarray, (x0, noise, x_t, tt, tn)))
    tx = tuple(map(t, (x0, noise, x_t, tt, tn)))
    pairs = [
        (js.q_sample(jx[0], jx[3], jx[1])[0], ts.q_sample(tx[0], tx[3], tx[1])[0]),
        (js.predict_start_from_noise(jx[2], jx[3], jx[1]),
         ts.predict_start_from_noise(tx[2], tx[3], tx[1])),
        (js.predict_start_from_v(jx[2], jx[3], jx[1]), ts.predict_start_from_v(tx[2], tx[3], tx[1])),
    ]
    pairs += list(zip(js.q_posterior(jx[0], jx[2], jx[3], t_next=jx[4])[:2],
                      ts.q_posterior(tx[0], tx[2], tx[3], t_next=tx[4])[:2]))
    for a, b in pairs:
        assert max_abs(b, a) <= 1e-5
    jt, jtn = js.get_sampling_timesteps(3)
    tt_, ttn = ts.get_sampling_timesteps(3)
    assert tt_.shape == (10, 3) and max_abs(tt_, jt) <= 1e-6 and max_abs(ttn, jtn) <= 1e-6


# --- attention ------------------------------------------------------------------------------

@pytest.mark.parametrize('masked', [False, True])
def test_attention_functions_match_jax(masked):
    r = rng(2)
    b, h, n, j, d = 2, 3, 10, 7, 8
    q = randn(r, b, n, h * d)
    k, v = randn(r, b, j, d), randn(r, b, j, d)
    qs, ks = 1. + randn(r, d, scale=0.1), 1. + randn(r, d, scale=0.1)
    mask = r.rand(b, j - 1) > 0.3 if masked else None
    kw = dict(scale=8., null_tokens=1)
    ref = jattn.multiquery_attention_packed(
        *map(jnp.asarray, (q, k, v)), h, mask=None if mask is None else jnp.asarray(mask),
        q_scale=jnp.asarray(qs), k_scale=jnp.asarray(ks), **kw)
    mine = attention.multiquery_attention_packed(
        t(q), t(k), t(v), h, mask=None if mask is None else t(mask),
        q_scale=t(qs), k_scale=t(ks), **kw)
    assert max_abs(mine, ref) <= 1e-5

    q4, k4, v4 = (randn(r, b, h, m, d) for m in (n, j, j))
    ref = jattn.multihead_attention(*map(jnp.asarray, (q4, k4, v4)),
                                    mask=None if mask is None else jnp.asarray(mask), **kw)
    mine = attention.multihead_attention(t(q4), t(k4), t(v4),
                                         mask=None if mask is None else t(mask), **kw)
    assert max_abs(mine, ref) <= 1e-5


# --- blocks that hold a kernel --------------------------------------------------------------

def _spy(monkeypatch, module, name):
    """Count the calls of `module.name` (a kernel wrapper) as the block runs."""
    calls = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def test_attention_block_matches_jax(monkeypatch):
    """32x32 tokens: the flash route (rows 2048, through the kernel wrapper)."""
    r = rng(3)
    x, ctx = randn(r, 2, 1024, 32), randn(r, 2, 5, 16)
    mod = jb.Attention(heads=2, dim_head=16, context_dim=16)
    p = random_params(mod, jnp.asarray(x[:1]), context=jnp.asarray(ctx[:1]), seed=3)
    ref = jax.jit(mod.apply)(jparams(p), jnp.asarray(x), context=jnp.asarray(ctx))
    mine = load_block(blocks.Attention(32, dim_head=16, heads=2, context_dim=16), p,
                      'mid_attn/attn_0', 'mid_attn.layers.0.0.')
    calls = _spy(monkeypatch, flash_attention, 'flash_cosine_mqa_rows')
    with torch.no_grad():
        out = mine(t(x), context=t(ctx))
    assert calls, 'the 32x32 attention did not take the flash route'
    assert max_abs(out, ref) <= TOL


def test_feedforward_block_matches_jax(monkeypatch):
    x = randn(rng(4), 2, 64, 128)
    mod = jb.FeedForward(mult=2.)
    p = random_params(mod, jnp.asarray(x), seed=4)
    ref = jax.jit(mod.apply)(jparams(p), jnp.asarray(x))
    mine = load_block(blocks.FeedForward(128, mult=2.), p, 'mid_attn/ff_0',
                      'mid_attn.layers.0.1.')
    calls = _spy(monkeypatch, fused_norm, 'fused_feedforward')
    with torch.no_grad():
        out = mine(t(x))
    assert calls, 'the feedforward did not take the fused route'
    assert max_abs(out, ref) <= TOL


def test_resnet_block_matches_jax(monkeypatch):
    """128x128, 256 -> 128 channels: both 3x3 convs through the conv wrapper;
    time FiLM, GlobalContext and the 1x1 residual conv on the way."""
    r = rng(5)
    x, temb = randn(r, 1, 128, 128, 256), randn(r, 1, 32)
    mod = jb.ResnetBlock(dim_out=128, time_cond_dim=32, use_gca=True)
    p = random_params(mod, jnp.asarray(x), time_emb=jnp.asarray(temb), seed=5)
    ref = jax.jit(mod.apply)(jparams(p), jnp.asarray(x), time_emb=jnp.asarray(temb))
    mine = load_block(blocks.ResnetBlock(256, 128, time_cond_dim=32, use_gca=True), p,
                      'mid_block1', 'mid_block1.')
    calls = _spy(monkeypatch, conv2d, 'conv2d_same')
    with torch.no_grad():
        out = mine(t(x), time_emb=t(temb))
    assert len(calls) == 2, 'the 3x3 convs did not take the kernel route'
    assert max_abs(out, ref) <= TOL


def test_perceiver_resampler_matches_jax(monkeypatch):
    x = randn(rng(6), 2, 8, 128)
    mod = jb.PerceiverResampler(depth=2, dim_head=16, heads=2, num_latents=4)
    p = random_params(mod, jnp.asarray(x), seed=6)
    ref = jax.jit(mod.apply)(jparams(p), jnp.asarray(x))
    mine = load_block(blocks.PerceiverResampler(128, depth=2, dim_head=16, heads=2,
                                                num_latents=4), p, 'attn_pool', 'attn_pool.')
    calls = _spy(monkeypatch, fused_norm, 'fused_feedforward')
    with torch.no_grad():
        out = mine(t(x))
    assert len(calls) == 2, 'the resampler feedforwards did not take the fused route'
    assert max_abs(out, ref) <= TOL


def test_wrappers_take_the_plain_version_on_cpu():
    """On a CPU tensor each wrapper returns its plain version's result."""
    r = rng(7)
    q, k, v = t(randn(r, 1, 256, 16)), t(randn(r, 1, 9, 16)), t(randn(r, 1, 9, 16))
    qs = t(1. + randn(r, 16, scale=0.1))
    assert torch.equal(flash_attention.flash_mqa_rows(q, k, v, 8.),
                       flash_attention.flash_rows_reference(q, k, v, 8.))
    assert torch.equal(flash_attention.flash_cosine_mqa_rows(q, k, v, qs, qs, 8.),
                       flash_attention.flash_rows_reference(
                           q, flash_attention.l2norm_scale(k, qs), v, 8., qs))
    x, w = t(randn(r, 1, 8, 64, 32)), t(randn(r, 3, 3, 32, 16))
    assert torch.equal(conv2d.conv2d_same(x, w, None), conv2d.conv2d_same_reference(x, w, None))
    x, w0, w1 = t(randn(r, 4, 32)), t(randn(r, 64, 32)), t(randn(r, 32, 64))
    g0, g1 = torch.ones(32), torch.ones(64)
    assert torch.equal(fused_norm.fused_feedforward(x, g0, w0, g1, w1, 1e-5),
                       fused_norm.feedforward_reference(x, g0, w0, g1, w1, 1e-5))
