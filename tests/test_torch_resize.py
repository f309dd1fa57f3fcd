"""Every `jax.image.resize` method in the port, and the cascades that take one.

Each method name against the JAX package's `resize_image_to`,
`resize_video_to` and `scale_video_time` to 1e-5: NHWC images up, down, at
the same size and at odd ratios (16 -> 64 -> 16, 64 -> 96 -> 64, 7 -> 13 ->
7), NFHWC video in time and space at once. Inputs are in the image range
[-1, 1]: at unit-normal scale JAX's own fp32 result is 8e-6 off the float64
product of its weights. Then tiny cascades at `resize_mode='linear'`
against JAX: a DDPM and an EDM 8 -> 16 image cascade, sampled through
`noise_override` (to 1e-2) and their training losses (the resized images
and low-res condition that reach the loss to 1e-6, the loss to 1e-5
relative); and a 4 -> 8 px video cascade with a temporal downsample factor
of 2 and `resize_cond_video_frames=False`, prompt frames given, with both
samplers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_bridge import BASE_CFG, SR_CFG, jparams, load_into, max_abs, randn, \
    random_params, rng, t

from imagen_tpu.diffusion.elucidated import ElucidatedImagen as JElucidated
from imagen_tpu.diffusion.imagen import Imagen as JImagen
from imagen_tpu.models import video_blocks as jvb
from imagen_tpu.models.unet2d import Unet as JUnet
from imagen_tpu.models.unet3d import Unet3D as JUnet3D
from imagen_tpu.ops import tensor_utils as jtu

import imagen_tpu_torch as it
from imagen_tpu_torch.models import video_blocks as tvb
from imagen_tpu_torch.ops import tensor_utils as ttu

CPU = 'cpu'
METHODS = ['nearest', 'linear', 'bilinear', 'trilinear', 'triangle', 'cubic', 'bicubic',
           'tricubic', 'lanczos3', 'lanczos5']


@pytest.mark.parametrize('method', METHODS[1:])
def test_resize_matches_jax(method):
    r = rng(METHODS.index(method))

    def image_range(*shape):
        return (r.rand(*shape) * 2 - 1).astype(np.float32)

    for size, target in ((16, 64), (64, 16), (16, 16), (64, 96), (96, 64), (7, 13), (13, 7)):
        x = image_range(2, size, size, 3)
        ref = jtu.resize_image_to(jnp.asarray(x), target, method=method)
        out = ttu.resize_image_to(t(x), target, method=method)
        assert out.shape == (2, target, target, 3)
        assert max_abs(out, ref) <= 1e-5, (size, target)
    clamped = ttu.resize_image_to(t(image_range(1, 16, 16, 3)), 40, clamp_range=(-.5, .5),
                                  method=method)
    assert float(clamped.abs().max()) <= .5

    video = image_range(2, 8, 12, 12, 2)
    for frames, target in ((4, 20), (12, 6), (8, 12)):
        ref = jvb.resize_video_to(jnp.asarray(video), target, target_frames=frames,
                                  method=method)
        out = tvb.resize_video_to(t(video), target, target_frames=frames, method=method)
        assert out.shape == (2, frames, target, target, 2)
        assert max_abs(out, ref) <= 1e-5, (frames, target)
    ref = jvb.scale_video_time(jnp.asarray(video), downsample_scale=2, method=method)
    assert max_abs(tvb.scale_video_time(t(video), 2, method=method), ref) <= 1e-5
    with pytest.raises(ValueError):
        ttu.resize_image_to(t(video[:, 0]), 6, method='area')


# --- cascades at resize_mode='linear' --------------------------------------------------------

B = 2
SIZES, STEPS = (8, 16), (3, 2)


def _params(junets, sizes, seed, video=False):
    out = []
    for i, (unet, size) in enumerate(zip(junets, sizes)):
        x = jnp.zeros((1, *((2,) if video else ()), size, size, 3))
        kw = dict(text_embeds=jnp.zeros((1, 8, 16)), text_mask=jnp.ones((1, 8), bool))
        if unet.lowres_cond:
            kw.update(lowres_cond_img=x, lowres_noise_times=jnp.zeros((1,)))
        out.append(random_params(unet, x, jnp.zeros((1,)), **kw, seed=seed + i))
    return out


def _cascades(sampler, cfgs, sizes, seed, video=False, **kwargs):
    """(JAX imagen, its params, the port's imagen) on the same weights."""
    jklass, tklass = ((JImagen, it.Imagen) if sampler == 'ddpm' else
                      (JElucidated, it.ElucidatedImagen))
    junet, tunet = (JUnet3D, it.Unet3D) if video else (JUnet, it.Unet)
    steps = dict(timesteps=STEPS) if sampler == 'ddpm' else dict(num_sample_steps=STEPS)
    common = dict(image_sizes=sizes, text_embed_dim=16, cond_drop_prob=0.1,
                  resize_mode='linear', **steps, **kwargs)
    jimagen = jklass(unets=tuple(junet(**c) for c in cfgs), **common)
    params = _params(jimagen.unets, sizes, seed, video)
    timagen = tklass([tunet(**c, device=CPU) for c in cfgs], device=CPU, **common)
    for unet, p in zip(timagen.unets, params):   # after the cascade set lowres_cond
        load_into(unet, p)
    return jimagen, params, timagen


def _text(r):
    mask = np.ones((B, 8), bool)
    mask[0, 5:] = False
    return randn(r, B, 8, 16) * mask[..., None], mask


def _noise(sampler, shapes):
    """The JAX `noise_override` draws of each stage at `shapes` (JAX's
    arrays) and the port's dicts of them."""
    r = rng(7)
    jax_noise, port = [], []
    for shape, n in zip(shapes, STEPS):
        init, per_step = randn(r, *shape), randn(r, n, *((1,) if sampler == 'edm' else ()),
                                                 *shape)
        if sampler == 'ddpm':
            jax_noise.append((jnp.asarray(init), jnp.asarray(per_step)))
            port.append({'init': t(init), 'steps': t(per_step)})
        else:
            jax_noise.append({'init': jnp.asarray(init), 'eps': jnp.asarray(per_step)})
            port.append({'init': t(init), 'eps': t(per_step)})
    return jax_noise, port


def _sample_both(sampler, jimagen, params, timagen, shapes, **kw):
    """Stage 1 from the same draws; stage 2 from JAX's stage-1 output, its
    low-res augmentation draw recomputed as JAX makes it. Returns the worst
    difference over the two stages."""
    jax_noise, port = _noise(sampler, shapes)
    key = jax.random.PRNGKey(0)
    ref = jimagen.sample(tuple(jparams(p) for p in params), key, cond_scale=3.,
                         noise_override=jax_noise, return_all_unet_outputs=True,
                         use_tqdm=False, **{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                                            else v for k, v in kw.items()})
    tkw = {k: t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    low = timagen.sample(cond_scale=3., noise_override=port, stop_at_unet_number=1, **tkw)
    port[1]['lowres'] = t(np.asarray(jax.random.normal(jax.random.fold_in(key, 1000 + 1),
                                                       shapes[1])))
    up = timagen.sample(cond_scale=3., noise_override=port, start_at_unet_number=2,
                        start_image_or_video=t(np.asarray(ref[0])), **tkw)
    assert low.shape == shapes[0] and up.shape == shapes[1]
    return max(max_abs(low, ref[0]), max_abs(up, ref[1]))


def _loss_inputs(imagen, call):
    """What `forward` hands `p_losses`, with p_losses stubbed out."""
    seen = {}

    def spy(*args, **kwargs):
        seen.update(args=args, kwargs=kwargs)
        return 0.
    imagen.p_losses = spy
    try:
        call()
    finally:
        del imagen.p_losses
    return seen['args'], seen['kwargs']


@pytest.mark.parametrize('sampler', ['ddpm', 'edm'])
def test_image_cascade_at_linear_resize_matches_jax(sampler):
    jimagen, params, timagen = _cascades(sampler, (BASE_CFG, SR_CFG), SIZES, seed=40)
    r = rng(41)
    emb, mask = _text(r)
    shapes = [(B, s, s, 3) for s in SIZES]
    assert _sample_both(sampler, jimagen, params, timagen, shapes, text_embeds=emb,
                        text_masks=mask) <= 1e-2

    # the training loss of stage 2 on 32 px images: resized to 16, the
    # low-res condition resized down to 8 and back up, both with 'linear';
    # no text drop, whose draws differ between the packages
    jimagen.cond_drop_prob = timagen.cond_drop_prob = 0.
    images = r.rand(B, 32, 32, 3).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jp = jax.tree_util.tree_map(jnp.asarray, params[1])
    if sampler == 'edm':
        sigmas, noise = np.asarray([0.3, 4.5], np.float32), randn(r, B, 16, 16, 3)
        ref = float(jax.jit(lambda p, *a: jimagen.forward(
            p, a[0], key, unet_number=2, text_embeds=a[1], text_masks=a[2], sigmas=a[3],
            noise=a[4]))(jparams(jp), *map(jnp.asarray, (images, emb, mask, sigmas, noise))))
        times = jimagen.lowres_noise_schedule_.sample_random_times(jax.random.split(key, 8)[1], 1)
        lrk = jax.random.split(jax.random.split(key, 8)[0])[1]
        with torch.no_grad():
            mine = float(timagen(
                t(images), unet_number=2, text_embeds=t(emb), text_masks=t(mask),
                sigmas=t(sigmas), noise=t(noise),
                lowres_aug_times=t(np.repeat(np.asarray(times), B)),
                lowres_aug_noise=t(np.asarray(jax.random.normal(lrk, (B, 16, 16, 3))))))
        assert ref > 1e-3 and abs(mine - ref) <= 1e-5 * abs(ref)
        return
    (_, _, jx, _, _), jkw = _loss_inputs(jimagen, lambda: jimagen.forward(
        jparams(jp), jnp.asarray(images), key, unet_number=2, text_embeds=jnp.asarray(emb),
        text_masks=jnp.asarray(mask)))
    (_, tx, _), tkw = _loss_inputs(timagen, lambda: timagen(
        t(images), unet_number=2, text_embeds=t(emb), text_masks=t(mask),
        generator=torch.Generator().manual_seed(0)))
    assert max_abs(tx, jx) <= 1e-6
    assert max_abs(tkw['lowres_cond_img'], jkw['lowres_cond_img']) <= 1e-6
    nearest = ttu.resize_image_to(ttu.resize_image_to(t(images), 8), 16)
    assert max_abs(tkw['lowres_cond_img'], nearest) > 0.05   # not the nearest resize
    times, noise = np.asarray([0.15, 0.8], np.float32), randn(r, B, 16, 16, 3)
    aug = np.asarray([0.3, 0.3], np.float32)
    lowres = np.asarray(jkw['lowres_cond_img'])
    ref = float(jax.jit(lambda p, *a: jimagen.p_losses(
        jimagen.unets[1], p, a[0], a[1], key, noise_scheduler=jimagen.noise_schedulers[1],
        text_embeds=a[2], text_mask=a[3], noise=a[4], lowres_cond_img=a[5],
        lowres_aug_times=a[6], pred_objective='noise',
        min_snr_gamma=jimagen.min_snr_gamma[1]))(
            jparams(jp), jx, *map(jnp.asarray, (times, emb, mask, noise, lowres, aug))))
    lrk = jax.random.split(key, 6)[2]
    with torch.no_grad():
        mine = float(timagen.p_losses(
            timagen.unets[1], tx, t(times), noise_scheduler=timagen.noise_schedulers[1],
            text_embeds=t(emb), text_mask=t(mask), noise=t(noise),
            lowres_cond_img=t(lowres), lowres_aug_times=t(aug),
            lowres_aug_noise=t(np.asarray(jax.random.normal(lrk, (B, 16, 16, 3)))),
            pred_objective='noise', min_snr_gamma=timagen.min_snr_gamma[1]))
    assert ref > 1e-3 and abs(mine - ref) <= 1e-5 * abs(ref)


TINY3D = dict(dim=8, dim_mults=(1, 2), text_embed_dim=16, cond_dim=8, attn_dim_head=4,
              attn_heads=2, attn_pool_num_latents=2, max_text_len=8, layer_attns=False,
              layer_cross_attns=(False, True))


@pytest.mark.parametrize('sampler', ['ddpm', 'edm'])
def test_video_cascade_with_unscaled_prompt_frames_matches_jax(sampler):
    """Stage 1 samples 2 of 4 frames at 4 px, stage 2 all 4 at 8 px; the 2
    prompt frames reach both stages unscaled in time."""
    sizes, frames = (4, 8), (2, 4)
    jimagen, params, timagen = _cascades(sampler, (TINY3D, TINY3D), sizes, seed=50, video=True,
                                         temporal_downsample_factor=(2, 1),
                                         resize_cond_video_frames=False)
    r = rng(51)
    emb, mask = _text(r)
    prompt = r.rand(B, 2, 8, 8, 3).astype(np.float32)
    shapes = [(B, f, s, s, 3) for f, s in zip(frames, sizes)]
    seen = []
    hook = timagen.unets[0].register_forward_pre_hook(
        lambda m, args, kwargs: seen.append(kwargs['cond_video_frames'].shape[1]),
        with_kwargs=True)
    worst = _sample_both(sampler, jimagen, params, timagen, shapes, text_embeds=emb,
                         text_masks=mask, video_frames=4, cond_video_frames=prompt)
    hook.remove()
    assert set(seen) == {2}   # stage 1 got both prompt frames
    assert worst <= 1e-2
