"""Self-conditioning and cond images in the port against the JAX package.

The 2-D U-Net's forward with `self_cond=True` and `cond_images_channels=3`
and low-res conditioning (every input of the init conv), plain and as the
guided doubled batch, fp32 to 1e-4 (the `Unet3D`'s in
`test_torch_self_cond_video.py`); the weights bridge of
the widened init conv, strict both ways. A self-conditioned, image-
conditioned 16 -> 32 DDPM cascade and a one-stage EDM one under the same
noise are in `test_torch_self_cond_sampling.py`; here, the training loss
with cond images and the self-conditioning pass, on both sides of its
coin, against JAX's `p_losses`, and `forward` handing the cond images to
`p_losses`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_bridge import BASE_CFG, jparams, load_into, max_abs, randn, \
    random_params, rng, t

from imagen_tpu.diffusion.imagen import Imagen as JImagen
from imagen_tpu.diffusion.imagen import unet_forward_with_cond_scale as jforward
from imagen_tpu.models.unet2d import Unet as JUnet
from imagen_tpu.models.unet3d import Unet3D as JUnet3D

import imagen_tpu_torch as it
from imagen_tpu_torch.diffusion.imagen import unet_forward_with_cond_scale
from imagen_tpu_torch.utils.port_weights import state_dict_from_jax

COND = dict(self_cond=True, cond_images_channels=3)
TINY3D = dict(dim=8, dim_mults=(1, 2), text_embed_dim=16, cond_dim=8, attn_dim_head=4,
              attn_heads=2, attn_pool_num_latents=2, max_text_len=8, layer_attns=False,
              layer_cross_attns=(False, True))
B = 2


# name: (video, unet options, prompt frames); every case low-res conditioned
# but the one with prompt frames, which the JAX Unet3D takes only where the
# frames' channels match x's (no self-conditioning there)
CASES = {'2d': (False, COND, False), '3d': (True, COND, False),
         '3d_prompt_frames': (True, dict(cond_images_channels=3), True)}


def _unet_inputs(case, seed):
    """(x, time, kwargs): cond images at half the size, which the unet
    resizes; with prompt frames, two preceding ones, which the cond images
    cover too."""
    video, options, prompt = CASES[case]
    r = rng(seed)
    lead = (B, 4) if video else (B,)
    x = randn(r, *lead, 8, 8, 3)
    kw = dict(text_embeds=randn(r, B, 6, 16), text_mask=np.ones((B, 6), bool),
              cond_images=r.rand(B, 4, 4, 3).astype(np.float32))
    kw['text_mask'][0, 4:] = False
    if options.get('self_cond'):
        kw['self_cond'] = randn(r, *lead, 8, 8, 3)
    if prompt:
        kw['cond_video_frames'] = r.rand(B, 2, 8, 8, 3).astype(np.float32)
    else:
        kw.update(lowres_cond_img=randn(r, *lead, 8, 8, 3),
                  lowres_noise_times=r.rand(B).astype(np.float32))
    return x, r.rand(B).astype(np.float32), kw


def _cfg(case):
    video, options, prompt = CASES[case]
    return {**(TINY3D if video else BASE_CFG), **options, 'lowres_cond': not prompt}


def _unets(case):
    cfg = _cfg(case)
    if CASES[case][0]:
        return JUnet3D(**cfg), it.Unet3D(**cfg, device='cpu')
    return JUnet(**cfg), it.Unet(**cfg, device='cpu')


def test_unet_forward_with_self_cond_and_cond_images_matches_jax():
    check_forward('2d')


def check_forward(case):
    """Plain, and guided at cond_scale 3, where the cond images and the
    self-conditioning x_start are doubled with the rest of the batch: that
    doubled forward to 1e-4, and the guided lerp (1 - s) * null + s * cond,
    which carries each half's error with a gain of up to |1 - s| + s, to
    5e-4. The `Unet3D` cases run in `test_torch_self_cond_video.py`."""
    junet, unet = _unets(case)
    x, time, kw = _unet_inputs(case, seed=len(case))
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    params = random_params(junet, jnp.asarray(x), jnp.asarray(time), seed=3, **jkw)
    seen = []

    class Recorded:   # the unet's own output: the doubled batch when guided
        def apply(self, *args, **kwargs):
            seen.append(junet.apply(*args, **kwargs))
            return seen[-1]

    def jax_side(v, x, tm, kw):
        seen.clear()
        plain = junet.apply(v, x, tm, **kw)
        return plain, jforward(Recorded(), v, x, tm, cond_scale=3., **kw), seen[0]

    ref, ref_guided, ref_doubled = jax.jit(jax_side)(jparams(params), jnp.asarray(x),
                                                     jnp.asarray(time), jkw)
    load_into(unet, params)
    doubled = []
    hook = unet.register_forward_hook(lambda m, a, out: doubled.append(out))
    tkw = {k: t(v) for k, v in kw.items()}
    with torch.no_grad():
        guided = unet_forward_with_cond_scale(unet, t(x), t(time), cond_scale=3., **tkw)
        hook.remove()
        out = unet(t(x), t(time), **tkw)
    assert out.shape == guided.shape == x.shape and doubled[0].shape[0] == 2 * B
    assert max_abs(out, ref) <= 1e-4
    assert max_abs(doubled[0], ref_doubled) <= 1e-4
    assert max_abs(guided, ref_guided) <= 1e-4 * (abs(1. - 3.) + 3.)

    with torch.no_grad():   # the cond images reach the output; no self_cond is zeros
        other = unet(t(x), t(time), **{**tkw, 'cond_images': tkw['cond_images'] + 1.})
        assert max_abs(other, out) > 1e-3
        if 'self_cond' in tkw:
            zeros = unet(t(x), t(time), **{**tkw, 'self_cond': torch.zeros(x.shape)})
            tkw.pop('self_cond')
            assert torch.equal(zeros, unet(t(x), t(time), **tkw))
    with pytest.raises(ValueError):
        unet(t(x), t(time), **{k: v for k, v in tkw.items() if k != 'cond_images'})


@pytest.mark.parametrize('case', ['2d', '2d_plain_init_conv', '3d'])
def test_weights_bridge_is_strict_both_ways(case):
    """The init conv (each CrossEmbed scale, or the plain conv) takes 3 + 3 +
    3 + 3 channels (cond images, x, self-conditioning, low-res); the keys
    are those of the same unet without the two options."""
    name = case.replace('_plain_init_conv', '')
    cfg = _cfg(name)
    if case != name:
        cfg['init_cross_embed'] = False
    junet = (JUnet3D if CASES[name][0] else JUnet)(**cfg)
    x, time, kw = _unet_inputs(name, seed=5)
    shapes = jax.eval_shape(lambda: junet.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(time),
        **{k: jnp.asarray(v) for k, v in kw.items()}))['params']
    sd = state_dict_from_jax(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                                    shapes))
    klass = it.Unet3D if CASES[name][0] else it.Unet
    unet = klass(**cfg, device='cpu')
    mine = unet.state_dict()
    assert len(sd) == len(jax.tree_util.tree_leaves(shapes))
    assert set(sd) == set(mine)
    for key, value in sd.items():
        assert value.shape == mine[key].shape, key
    unet.load_state_dict(sd, strict=True)
    init = [v for k, v in mine.items() if k.startswith('init_conv') and k.endswith('weight')]
    assert init and all(w.shape[1] == 12 for w in init)
    plain = klass(**{**cfg, 'self_cond': False, 'cond_images_channels': 0}, device='cpu')
    assert set(plain.state_dict()) == set(mine)


# --- training -----------------------------------------------------------------------------

def _text(r):
    mask = np.ones((B, 8), bool)
    mask[0, 6:] = False
    return randn(r, B, 8, 16) * mask[..., None], mask


def _key_with_flip(flip):
    """A key whose self-conditioning coin (`bernoulli` of the fourth key of
    JAX's split, imagen.py:794 and :866) comes up `flip`."""
    for seed in range(64):
        key = jax.random.PRNGKey(seed)
        if bool(jax.random.bernoulli(jax.random.split(key, 6)[3])) == flip:
            return key
    raise AssertionError('no key found')


@pytest.mark.parametrize('objective', ['noise', 'v'])
def test_p_losses_with_self_cond_and_cond_images_match_jax(objective):
    """Both sides of the coin, no text drop; the 'v' objective feeds its raw
    prediction back as JAX does."""
    cfg = {**BASE_CFG, **COND}
    kw = dict(image_sizes=(16,), text_embed_dim=16, cond_drop_prob=0., timesteps=4,
              pred_objectives=objective)
    jimagen = JImagen(unets=(JUnet(**cfg),), **kw)
    timagen = it.Imagen([it.Unet(**cfg, device='cpu')], device='cpu', **kw)
    x, time = jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,))
    params = random_params(jimagen.unets[0], x, time, text_embeds=jnp.zeros((1, 8, 16)),
                           text_mask=jnp.ones((1, 8), bool), cond_images=jnp.zeros((1, 8, 8, 3)),
                           seed=14)
    load_into(timagen.unets[0], params)
    r = rng(15)
    emb, mask = _text(r)
    inputs = dict(x_start=r.rand(B, 16, 16, 3).astype(np.float32),
                  times=np.asarray([0.15, 0.8], np.float32), noise=randn(r, B, 16, 16, 3),
                  text_embeds=emb, text_mask=mask,
                  cond_images=r.rand(B, 8, 8, 3).astype(np.float32))

    @jax.jit
    def jloss(p, inputs, key):
        inputs = dict(inputs)
        x_start, times = inputs.pop('x_start'), inputs.pop('times')
        return jimagen.p_losses(jimagen.unets[0], {'params': p}, x_start, times, key,
                                noise_scheduler=jimagen.noise_schedulers[0],
                                pred_objective=objective, min_snr_gamma=jimagen.min_snr_gamma[0],
                                **inputs)

    tin = {k: t(v) for k, v in inputs.items()}
    x_start, times = tin.pop('x_start'), tin.pop('times')
    losses = {}
    for flip in (False, True):
        ref = float(jloss(jparams(params)['params'],
                          {k: jnp.asarray(v) for k, v in inputs.items()}, _key_with_flip(flip)))
        with torch.no_grad():
            losses[flip] = float(timagen.p_losses(
                timagen.unets[0], x_start, times, noise_scheduler=timagen.noise_schedulers[0],
                pred_objective=objective, min_snr_gamma=timagen.min_snr_gamma[0],
                self_cond_flip=flip, **tin))
        assert ref > 1e-3
        assert abs(losses[flip] - ref) <= 1e-5 * abs(ref), flip
    assert abs(losses[True] - losses[False]) > 1e-4 * abs(losses[False])


def test_forward_hands_cond_images_to_p_losses_and_trains():
    """uint8 cond images reach `p_losses` as floats in [0, 1], give the loss
    of the same images as floats, and a trainer step takes them from the
    batch; the self-conditioning coin comes from the generator."""
    cfg = {**BASE_CFG, **COND}
    timagen = it.Imagen([it.Unet(**cfg, device='cpu')], image_sizes=(16,), text_embed_dim=16,
                        timesteps=4, device='cpu')
    r = rng(16)
    images = t(r.rand(B, 16, 16, 3).astype(np.float32))
    cond = t((r.rand(B, 8, 8, 3) * 255).astype(np.uint8))
    emb = t(randn(r, B, 8, 16))
    seen = {}
    p_losses = timagen.p_losses

    def spy(*args, **kwargs):
        seen.update(kwargs)
        return p_losses(*args, **kwargs)

    timagen.p_losses = spy
    try:
        with torch.no_grad():
            as_uint8 = timagen(images, text_embeds=emb, cond_images=cond,
                               generator=torch.Generator().manual_seed(2))
            assert torch.equal(seen['cond_images'], cond.float() / 255)
            as_float = timagen(images, text_embeds=emb, cond_images=cond.float() / 255,
                               generator=torch.Generator().manual_seed(2))
    finally:
        del timagen.p_losses
    assert torch.equal(as_uint8, as_float)
    calls = []
    hook = timagen.unets[0].register_forward_pre_hook(lambda *_: calls.append(1))
    forwards = set()
    for seed in range(8):   # both sides of the coin, from the generator alone
        calls.clear()
        with torch.no_grad():
            timagen(images, text_embeds=emb, cond_images=cond,
                    generator=torch.Generator().manual_seed(seed))
        forwards.add(len(calls))
    hook.remove()
    assert forwards == {1, 2}
    with torch.no_grad():   # zero at init, which stops every gradient below it
        timagen.unets[0].final_conv.weight.normal_(
            0., 0.02, generator=torch.Generator().manual_seed(3))
    trainer = it.ImagenTrainer(timagen, lr=1e-3, use_ema=False, seed=0, verbose=False)
    before = [p.detach().clone() for p in timagen.unets[0].init_conv.parameters()]
    loss = trainer.step_with_batch(dict(images=images, text_embeds=emb, cond_images=cond))
    assert np.isfinite(loss)
    after = list(timagen.unets[0].init_conv.parameters())
    assert all(bool(torch.isfinite(p).all()) and not torch.equal(p, b)
               for p, b in zip(after, before))
