"""The port's video sampling and serving against the JAX package.

A tiny one-stage video `Imagen` (the dim-8 `Unet3D`, 8 px, 3 DDPM steps,
classifier-free guidance at cond_scale 3, dynamic thresholding over every
frame) samples 16 frames in both packages with the same initial and step
noise through `noise_override`; the videos agree to 1e-2. A two-stage
cascade with a temporal downsample factor (4 frames at 16 px from 2 frames
at 8 px) is held the same way, its low-res augmentation noise recomputed
with the JAX expression. The server pads a request and answers with the
video shape.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_bridge import jparams, load_into, max_abs, randn, random_params, rng, t

from imagen_tpu.diffusion.imagen import Imagen as JImagen
from imagen_tpu.models.unet3d import Unet3D as JUnet3D

import imagen_tpu_torch as it

TINY = dict(dim=8, dim_mults=(1, 2), text_embed_dim=16, cond_dim=8, attn_dim_head=4,
            attn_heads=2, attn_pool_num_latents=2, max_text_len=8, layer_attns=False,
            layer_cross_attns=(False, True))


def _imagens(sizes, steps, seed, **kwargs):
    common = dict(image_sizes=sizes, text_embed_dim=16, timesteps=steps, cond_drop_prob=0.1,
                  **kwargs)
    jimagen = JImagen(unets=tuple(JUnet3D(**TINY) for _ in sizes), **common)
    params = []
    for i, (unet, size) in enumerate(zip(jimagen.unets, sizes)):
        x, time = jnp.zeros((1, 2, size, size, 3)), jnp.zeros((1,))
        kw = dict(text_embeds=jnp.zeros((1, 8, 16)), text_mask=jnp.ones((1, 8), bool))
        if unet.lowres_cond:
            kw.update(lowres_cond_img=x, lowres_noise_times=time)
        params.append(random_params(unet, x, time, **kw, seed=seed + i))
    tunets = [load_into(it.Unet3D(**TINY, lowres_cond=i > 0, device='cpu'), p)
              for i, p in enumerate(params)]
    timagen = it.Imagen(tunets, device='cpu', **common)
    return jimagen, tuple(jparams(p) for p in params), timagen


@pytest.fixture(scope='module')
def one_stage():
    return _imagens((8,), 3, seed=50)


def _text(seed, b):
    r = rng(seed)
    mask = np.ones((b, 8), bool)
    mask[0, 5:] = False
    return r, randn(r, b, 8, 16) * mask[..., None], mask


def test_sixteen_frame_sample_matches_jax(one_stage):
    jimagen, params, timagen = one_stage
    b, f, s, steps = 2, 16, 8, 3
    r, emb, mask = _text(51, b)
    noise = (randn(r, b, f, s, s, 3), randn(r, steps, b, f, s, s, 3))
    ref = jimagen.sample(params, jax.random.PRNGKey(0), text_embeds=jnp.asarray(emb),
                         text_masks=jnp.asarray(mask), video_frames=f, cond_scale=3.,
                         noise_override=[tuple(map(jnp.asarray, noise))], use_tqdm=False)
    out = timagen.sample(text_embeds=t(emb), text_masks=t(mask), video_frames=f,
                         cond_scale=3., noise_override=[(t(noise[0]), t(noise[1]), None)])
    assert timagen.is_video and out.shape == (b, f, s, s, 3)
    assert max_abs(out, ref) <= 1e-2


def test_two_stage_video_cascade_matches_jax():
    """Stage 1 samples 2 frames at 8 px, stage 2 upsamples them in space and
    time to 4 frames at 16 px (temporal_downsample_factor (2, 1))."""
    sizes, steps = (8, 16), (2, 2)
    jimagen, params, timagen = _imagens(sizes, steps, seed=60,
                                        temporal_downsample_factor=(2, 1))
    b, frames = 2, (2, 4)
    r, emb, mask = _text(61, b)
    noise = [(randn(r, b, f, s, s, 3), randn(r, n, b, f, s, s, 3))
             for f, s, n in zip(frames, sizes, steps)]
    key = jax.random.PRNGKey(0)
    ref = jimagen.sample(params, key, text_embeds=jnp.asarray(emb),
                         text_masks=jnp.asarray(mask), video_frames=4, cond_scale=3.,
                         noise_override=[tuple(map(jnp.asarray, n)) for n in noise],
                         use_tqdm=False)
    # the low-res aug noise of stage 2, as JAX draws it
    lowres = np.asarray(jax.random.normal(jax.random.fold_in(key, 1000 + 1),
                                          (b, frames[1], sizes[1], sizes[1], 3)))
    override = [(t(noise[0][0]), t(noise[0][1]), None),
                (t(noise[1][0]), t(noise[1][1]), t(lowres))]
    out = timagen.sample(text_embeds=t(emb), text_masks=t(mask), video_frames=4,
                         cond_scale=3., noise_override=override)
    assert out.shape == (b, 4, 16, 16, 3)
    assert max_abs(out, ref) <= 1e-2
    with pytest.raises(ValueError):  # 3 frames do not divide by the factor 2
        timagen.sample(text_embeds=t(emb), video_frames=3)
    with pytest.raises(ValueError):  # nor in training
        timagen(torch.zeros(b, 3, 16, 16, 3), unet_number=1, text_embeds=t(emb))


def test_video_server_pads_a_small_request(one_stage):
    _, _, timagen = one_stage
    server = it.ImagenServer(timagen, batch_size=2, text_len=8, cond_scale=3., seed=1,
                             video_frames=4)
    r = rng(52)
    emb = randn(r, 1, 6, 16)
    video = server.generate(text_embeds=t(emb), generator=torch.Generator().manual_seed(5))
    assert video.shape == (1, 4, 8, 8, 3)
    assert np.isfinite(video).all() and video.min() >= 0. and video.max() <= 1.

    padded, masks, n = server._pad_request(t(emb), torch.ones(1, 6, dtype=torch.bool))
    direct = timagen.sample(text_embeds=padded, text_masks=masks, video_frames=4,
                            cond_scale=3., generator=torch.Generator().manual_seed(5))
    assert max_abs(video, direct[:1]) == 0.
    with pytest.raises(ValueError):
        timagen.sample(text_embeds=padded)  # a video cascade needs video_frames
