"""`Imagen.p_losses` of the port against the JAX package, fp32, on the CPU.

The base and SR stages, the three objectives, min-SNR weighting on and no
text drop, with the same seeded images, times, noise and weights (bridged by
`state_dict_from_jax`) on both sides: 1e-5 relative. The l1, l2 and huber
losses against the JAX package's, and the paired random crop of the SR
stages (its offsets come from each package's own generator, so it is held
to what it must do rather than to JAX's draws).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_bridge import BASE_CFG, SR_CFG, jparams, load_into, max_abs, randn, \
    random_params, rng, t

from imagen_tpu.diffusion.imagen import LOSS_FNS as JLOSS_FNS
from imagen_tpu.diffusion.imagen import Imagen as JImagen
from imagen_tpu.models.unet2d import Unet as JUnet

import imagen_tpu_torch as it
from imagen_tpu_torch.diffusion.imagen import LOSS_FNS, _per_sample_random_crop

CPU = 'cpu'


def _cascade(stage, objective):
    """(JAX imagen, port imagen, unet index, JAX params of that unet): the base
    stage alone at 16 px, or the SR stage of an 8 -> 16 cascade."""
    cfgs = (BASE_CFG,) if stage == 'base' else (BASE_CFG, SR_CFG)
    sizes = (16,) if stage == 'base' else (8, 16)
    kw = dict(image_sizes=sizes, text_embed_dim=16, cond_drop_prob=0., timesteps=4,
              pred_objectives=objective)
    jimagen = JImagen(unets=tuple(JUnet(**c) for c in cfgs), **kw)
    timagen = it.Imagen([it.Unet(**c, device=CPU) for c in cfgs], device=CPU, **kw)
    index = len(cfgs) - 1
    junet = jimagen.unets[index]
    x, time = jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,))
    ukw = dict(text_embeds=jnp.zeros((1, 8, 16)), text_mask=jnp.ones((1, 8), bool))
    if junet.lowres_cond:
        ukw.update(lowres_cond_img=x, lowres_noise_times=time)
    params = random_params(junet, x, time, **ukw, seed=40 + index)
    load_into(timagen.unets[index], params)
    return jimagen, timagen, index, params


def _loss_inputs(stage, seed=5, b=2):
    r = rng(seed)
    mask = np.ones((b, 8), bool)
    mask[1, 6:] = False
    inputs = dict(x_start=r.rand(b, 16, 16, 3).astype(np.float32),
                  times=np.asarray([0.15, 0.8], np.float32)[:b],
                  noise=randn(r, b, 16, 16, 3),
                  text_embeds=randn(r, b, 8, 16) * mask[..., None], text_mask=mask)
    if stage == 'sr':
        inputs.update(lowres_cond_img=r.rand(b, 16, 16, 3).astype(np.float32),
                      lowres_aug_times=np.asarray([0.3, 0.05], np.float32)[:b])
    return inputs


def _jax_loss(jimagen, index, params, inputs, key):
    inputs = {k: jnp.asarray(v) for k, v in inputs.items()}
    x_start, times = inputs.pop('x_start'), inputs.pop('times')
    return jimagen.p_losses(
        jimagen.unets[index], jparams(params), x_start, times, key,
        noise_scheduler=jimagen.noise_schedulers[index],
        pred_objective=jimagen.pred_objectives[index],
        min_snr_gamma=jimagen.min_snr_gamma[index], **inputs)


@pytest.mark.parametrize('objective', ['noise', 'x_start', 'v'])
@pytest.mark.parametrize('stage', ['base', 'sr'])
def test_p_losses_match_jax(stage, objective):
    jimagen, timagen, index, params = _cascade(stage, objective)
    inputs = _loss_inputs(stage)
    key = jax.random.PRNGKey(3)
    ref = float(jax.jit(partial(_jax_loss, jimagen, index))(params, inputs, key))
    tin = {k: t(v) for k, v in inputs.items()}
    if stage == 'sr':
        # JAX draws the low-res augmentation noise from the third key of its
        # split (imagen.py:794); the port takes it as an argument
        lrk = jax.random.split(key, 6)[2]
        tin['lowres_aug_noise'] = t(np.asarray(jax.random.normal(lrk, (2, 16, 16, 3))))
    x_start, times = tin.pop('x_start'), tin.pop('times')
    with torch.no_grad():
        mine = float(timagen.p_losses(
            timagen.unets[index], x_start, times,
            noise_scheduler=timagen.noise_schedulers[index],
            pred_objective=timagen.pred_objectives[index],
            min_snr_gamma=timagen.min_snr_gamma[index], **tin))
    assert ref > 1e-3
    assert abs(mine - ref) <= 1e-5 * abs(ref)


@pytest.mark.parametrize('loss_type', ['l1', 'l2', 'huber'])
def test_loss_functions_match_jax(loss_type):
    r = rng(8)
    pred, target = randn(r, 4, 6, 6, 3, scale=2.), randn(r, 4, 6, 6, 3)
    ref = JLOSS_FNS[loss_type](jnp.asarray(pred), jnp.asarray(target))
    assert max_abs(LOSS_FNS[loss_type](t(pred), t(target)), ref) <= 1e-6


def test_random_crop_takes_the_same_window_of_every_tensor():
    r = rng(9)
    x = t(randn(r, 5, 16, 16, 3))
    cx, cy = _per_sample_random_crop((x, x * 2. + 1.), 8, torch.Generator().manual_seed(0))
    assert cx.shape == (5, 8, 8, 3)
    assert torch.equal(cy, cx * 2. + 1.)
    for i in range(5):  # each crop is an 8x8 window of its own sample
        assert any(torch.equal(cx[i], x[i, a:a + 8, b:b + 8])
                   for a in range(9) for b in range(9))
    # an SR stage trained on crops of its images
    timagen = it.Imagen([it.Unet(**c, device=CPU) for c in (BASE_CFG, SR_CFG)],
                        image_sizes=(8, 16), random_crop_sizes=(None, 8), text_embed_dim=16,
                        timesteps=4, device=CPU)
    loss = timagen(t(r.rand(2, 16, 16, 3).astype(np.float32)), unet_number=2,
                   text_embeds=t(randn(r, 2, 8, 16)), generator=torch.Generator().manual_seed(1))
    assert loss.ndim == 0 and bool(torch.isfinite(loss))


@pytest.mark.parametrize('per_sample', [False, True])
def test_forward_takes_uint8_images_and_draws_aug_levels(per_sample):
    """uint8 images train as the same images in [0, 1]; the SR stage's
    low-res augmentation level is one draw for the batch, or one per sample
    with `per_sample_random_aug_noise_level`."""
    r = rng(10)
    timagen = it.Imagen([it.Unet(**c, device=CPU) for c in (BASE_CFG, SR_CFG)],
                        image_sizes=(8, 16), text_embed_dim=16, timesteps=4,
                        per_sample_random_aug_noise_level=per_sample, device=CPU)
    seen = {}
    p_losses = timagen.p_losses

    def spy(*args, **kwargs):
        seen.update(kwargs)
        return p_losses(*args, **kwargs)

    timagen.p_losses = spy
    images = t((r.rand(3, 16, 16, 3) * 255).astype(np.uint8))
    emb = t(randn(r, 3, 8, 16))
    with torch.no_grad():
        as_uint8 = timagen(images, unet_number=2, text_embeds=emb,
                           generator=torch.Generator().manual_seed(2))
        as_float = timagen(images.float() / 255, unet_number=2, text_embeds=emb,
                           generator=torch.Generator().manual_seed(2))
    assert torch.equal(as_uint8, as_float)
    levels = seen['lowres_aug_times']
    assert levels.shape == (3,) and bool(((levels >= 0) & (levels < 1)).all())
    assert (len(set(levels.tolist())) == 3) == per_sample
