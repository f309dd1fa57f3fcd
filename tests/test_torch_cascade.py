"""The port's 2-stage cascade sampler and server against the JAX package.

A tiny 16 -> 32 cascade (the dim-8 base and SR configs, 3 + 2 DDPM steps,
classifier-free guidance at cond_scale 3, dynamic thresholding, low-res
noise-aug conditioning) sampled by JAX with `noise_override` and by the port
with the same noise; samples agree to 1e-2. The low-res aug noise, which JAX
draws itself, is recomputed with the JAX expression and handed to the port.
"""
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_bridge import BASE_CFG, SR_CFG, StandInEncoder, inject_t5, load_into, max_abs, \
    randn, random_params, rng, t

from imagen_tpu.diffusion.imagen import Imagen as JImagen
from imagen_tpu.models.unet2d import Unet as JUnet

import imagen_tpu_torch as it

REPO = Path(__file__).resolve().parents[1]
SIZES, STEPS = (16, 32), (3, 2)


@pytest.fixture(scope='module')
def cascades():
    junets = (JUnet(**BASE_CFG), JUnet(**SR_CFG))
    jimagen = JImagen(unets=junets, image_sizes=SIZES, text_embed_dim=16, timesteps=STEPS,
                      cond_drop_prob=0.1)
    params = []
    for i, (unet, size) in enumerate(zip(jimagen.unets, SIZES)):
        x, time = jnp.zeros((1, size, size, 3)), jnp.zeros((1,))
        kw = dict(text_embeds=jnp.zeros((1, 8, 16)), text_mask=jnp.ones((1, 8), bool))
        if unet.lowres_cond:
            kw.update(lowres_cond_img=x, lowres_noise_times=time)
        params.append(random_params(unet, x, time, **kw, seed=20 + i))
    tunets = [load_into(it.Unet(**cfg, device='cpu'), p) for cfg, p in zip((BASE_CFG, SR_CFG), params)]
    timagen = it.Imagen(tunets, image_sizes=SIZES, text_embed_dim=16, timesteps=STEPS,
                        cond_drop_prob=0.1, device='cpu')
    return jimagen, params, timagen


def test_cascade_samples_match_jax(cascades):
    jimagen, params, timagen = cascades
    b = 2
    r = rng(30)
    mask = np.ones((b, 8), bool)
    mask[0, 6:] = False
    emb = randn(r, b, 8, 16) * mask[..., None]
    noise = [(randn(r, b, s, s, 3), randn(r, n, b, s, s, 3)) for s, n in zip(SIZES, STEPS)]
    key = jax.random.PRNGKey(0)

    ref = jimagen.sample(
        tuple({'params': jax.tree_util.tree_map(jnp.asarray, p)} for p in params), key,
        text_embeds=jnp.asarray(emb), text_masks=jnp.asarray(mask), cond_scale=3.,
        noise_override=[tuple(map(jnp.asarray, n)) for n in noise], use_tqdm=False)

    # the low-res aug noise of stage 2, as JAX draws it (imagen.py:707-710)
    lowres_noise = np.asarray(jax.random.normal(jax.random.fold_in(key, 1000 + 1),
                                                (b, SIZES[1], SIZES[1], 3)))
    override = [(t(noise[0][0]), t(noise[0][1]), None),
                (t(noise[1][0]), t(noise[1][1]), t(lowres_noise))]
    out = timagen.sample(text_embeds=t(emb), text_masks=t(mask), cond_scale=3.,
                         noise_override=override)
    assert out.shape == (b, SIZES[1], SIZES[1], 3)
    assert max_abs(out, ref) <= 1e-2


def test_start_and_stop_at_unet_number(cascades):
    """Stopping after stage 1, then upscaling its image from stage 2 with the
    same noise, gives the full cascade's sample."""
    _, _, timagen = cascades
    r = rng(32)
    emb = t(randn(r, 2, 8, 16))
    noise = [(t(randn(r, 2, s, s, 3)), t(randn(r, n, 2, s, s, 3))) for s, n in zip(SIZES, STEPS)]
    lowres = t(randn(r, 2, SIZES[1], SIZES[1], 3))
    override = [(*noise[0], None), (*noise[1], lowres)]
    full = timagen.sample(text_embeds=emb, cond_scale=3., noise_override=override)
    low = timagen.sample(text_embeds=emb, cond_scale=3., noise_override=override,
                         stop_at_unet_number=1)
    assert low.shape == (2, SIZES[0], SIZES[0], 3)
    up = timagen.sample(text_embeds=emb, cond_scale=3., noise_override=override,
                        start_at_unet_number=2, start_image_or_video=low)
    assert max_abs(up, full) == 0.


def test_server_pads_a_small_request(cascades, monkeypatch):
    _, _, timagen = cascades
    server = it.ImagenServer(timagen, batch_size=2, text_len=8, cond_scale=3., seed=1)
    r = rng(31)
    emb = randn(r, 1, 6, 16)
    images = server.generate(text_embeds=t(emb), generator=torch.Generator().manual_seed(5))
    assert images.shape == (1, SIZES[1], SIZES[1], 3)
    assert np.isfinite(images).all() and images.min() >= 0. and images.max() <= 1.

    # the same padded batch sampled directly gives the same image
    padded, masks, n = server._pad_request(t(emb), torch.ones(1, 6, dtype=torch.bool))
    assert padded.shape == (2, 8, 16) and n == 1 and masks[1].sum() == 1
    direct = timagen.sample(text_embeds=padded, text_masks=masks, cond_scale=3.,
                            generator=torch.Generator().manual_seed(5))
    assert max_abs(images, direct[:1]) == 0.

    with pytest.raises(ValueError):
        server.generate(text_embeds=t(randn(r, 3, 8, 16)))
    # raw texts go through the cascade's T5 encoder (a stand-in here)
    inject_t5(monkeypatch, StandInEncoder(16), name=timagen.text_encoder_name)
    texts = ['a prompt', 'two more words']
    emb, mask = timagen.encode_text(texts, return_attn_mask=True)
    by_text = server.generate(texts=texts, generator=torch.Generator().manual_seed(5))
    by_embeds = server.generate(text_embeds=emb, text_masks=mask,
                                generator=torch.Generator().manual_seed(5))
    assert by_text.shape == (2, SIZES[1], SIZES[1], 3) and max_abs(by_text, by_embeds) == 0.
    with pytest.raises(ValueError):
        server.generate(texts=texts, text_embeds=emb)


def test_server_serves_concurrent_callers(cascades):
    """More threads than cores (up to 16) call `generate` at once; each one's
    image is the one a lone call with the same seed gives."""
    _, _, timagen = cascades
    server = it.ImagenServer(timagen, batch_size=2, text_len=8, cond_scale=3., seed=1)
    emb = t(randn(rng(33), 1, 8, 16))
    expected = server.generate(text_embeds=emb, generator=torch.Generator().manual_seed(7))
    n_threads = min((os.cpu_count() or 1) + 1, 16)
    results, errors = [None] * n_threads, []

    def call(i):
        try:
            results[i] = server.generate(text_embeds=emb,
                                         generator=torch.Generator().manual_seed(7))
        except Exception as e:  # surfaced by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=call, args=(i,)) for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    for images in results:
        assert max_abs(images, expected) == 0.


def test_import_leaves_jax_out():
    code = 'import sys, imagen_tpu_torch; sys.exit(int("jax" in sys.modules))'
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
