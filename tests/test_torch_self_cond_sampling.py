"""A self-conditioned, image-conditioned DDPM cascade and a self-conditioned
EDM stage of the port against the JAX package.

A 16 -> 32 cascade of the dim-8 base and SR unets, both built with
`self_cond=True` and `cond_images_channels=3`, 3 + 2 DDPM steps, guided at
cond_scale 3 (so the cond images and each step's x_start are doubled with
the batch), uint8 cond images, every draw fed through `noise_override` and
the low-res augmentation draw recomputed as JAX makes it; and one
self-conditioned EDM stage, 3 churn + Heun steps. Samples agree to 1e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np

from torch_port_bridge import BASE_CFG, SR_CFG, jparams, load_into, max_abs, randn, \
    random_params, rng, t

from imagen_tpu.diffusion.elucidated import ElucidatedImagen as JElucidated
from imagen_tpu.diffusion.imagen import Imagen as JImagen
from imagen_tpu.models.unet2d import Unet as JUnet

import imagen_tpu_torch as it

COND = dict(self_cond=True, cond_images_channels=3)
B = 2

SIZES, STEPS = (16, 32), (3, 2)


def _cascade_params(junets, seed):
    params = []
    for i, (unet, size) in enumerate(zip(junets, SIZES)):
        x, time = jnp.zeros((1, size, size, 3)), jnp.zeros((1,))
        kw = dict(text_embeds=jnp.zeros((1, 8, 16)), text_mask=jnp.ones((1, 8), bool),
                  cond_images=jnp.zeros((1, 8, 8, 3)))
        if unet.lowres_cond:
            kw.update(lowres_cond_img=x, lowres_noise_times=time)
        params.append(random_params(unet, x, time, **kw, seed=seed + i))
    return params


def _text(r):
    mask = np.ones((B, 8), bool)
    mask[0, 6:] = False
    return randn(r, B, 8, 16) * mask[..., None], mask


def test_self_conditioned_cascade_matches_jax():
    """Both stages self-conditioned and image-conditioned (9 input channels,
    12 with the low-res image), guided at cond_scale 3."""
    kw = dict(image_sizes=SIZES, text_embed_dim=16, timesteps=STEPS, cond_drop_prob=0.1)
    cfgs = ({**BASE_CFG, **COND}, {**SR_CFG, **COND})
    jimagen = JImagen(unets=tuple(JUnet(**c) for c in cfgs), **kw)
    params = _cascade_params(jimagen.unets, seed=10)
    timagen = it.Imagen([load_into(it.Unet(**c, device='cpu'), p) for c, p in zip(cfgs, params)],
                        device='cpu', **kw)
    r = rng(11)
    emb, mask = _text(r)
    cond = (r.rand(B, 8, 8, 3) * 255).astype(np.uint8)
    noise = [(randn(r, B, s, s, 3), randn(r, n, B, s, s, 3)) for s, n in zip(SIZES, STEPS)]
    key = jax.random.PRNGKey(0)
    ref = jimagen.sample(tuple(jparams(p) for p in params), key, text_embeds=jnp.asarray(emb),
                         text_masks=jnp.asarray(mask), cond_images=jnp.asarray(cond),
                         cond_scale=3., noise_override=[tuple(map(jnp.asarray, n)) for n in noise],
                         use_tqdm=False)
    lowres = np.asarray(jax.random.normal(jax.random.fold_in(key, 1000 + 1),
                                          (B, SIZES[1], SIZES[1], 3)))
    override = [(t(noise[0][0]), t(noise[0][1]), None),
                (t(noise[1][0]), t(noise[1][1]), t(lowres))]
    out = timagen.sample(text_embeds=t(emb), text_masks=t(mask), cond_images=t(cond),
                         cond_scale=3., noise_override=override)
    assert out.shape == (B, SIZES[1], SIZES[1], 3)
    assert max_abs(out, ref) <= 1e-2


def test_self_conditioned_edm_stage_matches_jax():
    """One EDM stage: each Euler call sees the previous denoised output, each
    Heun call the Euler call's."""
    kw = dict(image_sizes=SIZES[:1], text_embed_dim=16, num_sample_steps=3, cond_drop_prob=0.1)
    cfg = {**BASE_CFG, 'self_cond': True}
    jimagen = JElucidated(unets=(JUnet(**cfg),), **kw)
    x, time = jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,))
    params = random_params(jimagen.unets[0], x, time, text_embeds=jnp.zeros((1, 8, 16)),
                           text_mask=jnp.ones((1, 8), bool), seed=12)
    timagen = it.ElucidatedImagen((load_into(it.Unet(**cfg, device='cpu'), params),),
                                  device='cpu', **kw)
    r = rng(13)
    emb, mask = _text(r)
    noise = {'init': randn(r, B, 16, 16, 3), 'eps': randn(r, 3, 1, B, 16, 16, 3)}
    ref = jimagen.sample((jparams(params),), jax.random.PRNGKey(0), text_embeds=jnp.asarray(emb),
                         text_masks=jnp.asarray(mask), cond_scale=3., use_tqdm=False,
                         noise_override=[{k: jnp.asarray(v) for k, v in noise.items()}])
    out = timagen.sample(text_embeds=t(emb), text_masks=t(mask), cond_scale=3.,
                         noise_override=[{k: t(v) for k, v in noise.items()}])
    assert out.shape == (B, 16, 16, 3)
    assert max_abs(out, ref) <= 1e-2
