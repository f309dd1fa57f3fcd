"""The port's EDM training loss (`ElucidatedImagen.forward`) against the JAX
package's, fp32 on the CPU.

The same seeded images, text, sigmas and noise (the JAX hooks `sigmas=` and
`noise=`) and the same weights (bridged by `state_dict_from_jax`) on both
sides, no text drop; the low-res augmentation times and noise recomputed
from the JAX key as JAX draws them (`ak = split(key, 8)[1]`, the noise from
`split(split(key, 8)[0])[1]`) and handed to the port, and a `self_cond`
unet's coin (`bernoulli(split(key, 8)[5])`) taken from keys that land each
way. The loss to 1e-5 relative for the base stage, the SR stage with its
low-res augmentation, a `self_cond` unet with the coin both ways, a
4-frame `Unet3D` clip and still images into a video cascade; every
parameter's gradient against `jax.grad`, to 1e-4 of the largest in float64
on both sides and to 1e-3 of it in fp32. Then the
paired random crop of the images and the low-res condition, with noise of
the cropped shape, and training through `ImagenTrainer`.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_bridge import BASE_CFG, SR_CFG, load_into, max_abs, randn, random_params, \
    rng, softmax_in_input_dtype, t

from imagen_tpu.diffusion.elucidated import ElucidatedImagen as JElucidated
from imagen_tpu.models.unet2d import Unet as JUnet
from imagen_tpu.models.unet3d import Unet3D as JUnet3D

import imagen_tpu_torch as it
from imagen_tpu_torch.utils.port_weights import state_dict_from_jax

CPU = 'cpu'
TINY3D = dict(dim=8, dim_mults=(1, 2), text_embed_dim=16, cond_dim=8, attn_dim_head=4,
              attn_heads=2, attn_pool_num_latents=2, max_text_len=8, layer_attns=False,
              layer_cross_attns=(False, True))
B = 2
# name: (unet configs, video, image sizes, the unet trained, the batch's shape)
CASES = {
    'base': ((BASE_CFG,), False, (16,), 1, (B, 16, 16, 3)),
    'sr': ((BASE_CFG, SR_CFG), False, (8, 16), 2, (B, 16, 16, 3)),
    'self_cond': (({**BASE_CFG, 'self_cond': True},), False, (16,), 1, (B, 16, 16, 3)),
    'video': ((TINY3D,), True, (8,), 1, (B, 4, 8, 8, 3)),
    'video_stills': ((TINY3D,), True, (8,), 1, (B, 8, 8, 3)),
}


def _cascades(name, dtype='float32'):
    cfgs, video, sizes, number, _ = CASES[name]
    jcls, tcls = (JUnet3D, it.Unet3D) if video else (JUnet, it.Unet)
    kw = dict(image_sizes=sizes, text_embed_dim=16, cond_drop_prob=0.)
    jimagen = JElucidated(unets=tuple(jcls(**c, dtype=getattr(jnp, dtype)) for c in cfgs), **kw)
    timagen = it.ElucidatedImagen([tcls(**c, dtype=getattr(torch, dtype), device=CPU)
                                   for c in cfgs], device=CPU, **kw)
    index = number - 1
    size = sizes[index]
    x = jnp.zeros((1, 2, size, size, 3) if video else (1, size, size, 3))
    ukw = dict(text_embeds=jnp.zeros((1, 8, 16)), text_mask=jnp.ones((1, 8), bool))
    if index > 0:
        ukw.update(lowres_cond_img=x, lowres_noise_times=jnp.zeros((1,)))
    params = random_params(jimagen.unets[index], x, jnp.zeros((1,)), **ukw, seed=60 + index)
    params = jax.tree_util.tree_map(lambda a: a.astype(dtype), params)
    load_into(timagen.unets[index], params).to(getattr(torch, dtype))
    return jimagen, timagen, params


def _inputs(name, seed=61, dtype='float32'):
    """Images, text and mask, sigmas and the noise at the stage's shape."""
    _, video, sizes, number, shape = CASES[name]
    r = rng(seed)
    mask = np.ones((B, 8), bool)
    mask[1, 5:] = False
    size = sizes[number - 1]
    stage = (B, 4, size, size, 3) if len(shape) == 5 else (B, size, size, 3)
    if video and len(shape) == 4:   # still images train as one-frame clips
        stage = (B, 1, size, size, 3)
    inputs = dict(images=r.rand(*shape), text_embeds=randn(r, B, 8, 16) * mask[..., None],
                  sigmas=np.asarray([0.3, 4.5]), noise=randn(r, *stage))
    return dict({k: v.astype(dtype) for k, v in inputs.items()}, text_masks=mask)


def _jax_loss(jimagen, number, p, key, inputs):
    return jimagen.forward({'params': p}, inputs['images'], key, unet_number=number,
                           text_embeds=inputs['text_embeds'], text_masks=inputs['text_masks'],
                           sigmas=inputs['sigmas'], noise=inputs['noise'])


def _jax_draws(jimagen, name, key):
    """The low-res augmentation times and noise that JAX draws from `key`
    (`elucidated.py`: `ak` and `lrk`), as the port's keyword arguments."""
    _, video, sizes, number, shape = CASES[name]
    if number == 1:
        return {}
    times = jimagen.lowres_noise_schedule_.sample_random_times(jax.random.split(key, 8)[1], 1)
    lrk = jax.random.split(jax.random.split(key, 8)[0])[1]
    size = sizes[number - 1]
    noise = jax.random.normal(lrk, (B, *shape[1:-3], size, size, 3))
    return dict(lowres_aug_times=t(np.repeat(np.asarray(times), B)),
                lowres_aug_noise=t(np.asarray(noise)))


def _coin_key(flip):
    """A key whose self-conditioning coin (`bernoulli(split(key, 8)[5])`) is `flip`."""
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        if bool(jax.random.bernoulli(jax.random.split(key, 8)[5])) == flip:
            return key
    raise AssertionError('no key found')


def _port_loss(timagen, name, inputs, draws, **kwargs):
    number = CASES[name][3]
    return timagen(t(inputs['images']), unet_number=number, text_embeds=t(inputs['text_embeds']),
                   text_masks=t(inputs['text_masks']), sigmas=t(inputs['sigmas']),
                   noise=t(inputs['noise']), generator=torch.Generator().manual_seed(0),
                   **draws, **kwargs)


@pytest.mark.parametrize('name,flip', [('base', None), ('sr', None), ('self_cond', False),
                                       ('self_cond', True), ('video', None),
                                       ('video_stills', None)])
def test_edm_loss_matches_jax(name, flip):
    jimagen, timagen, params = _cascades(name)
    inputs = _inputs(name)
    number = CASES[name][3]
    key = jax.random.PRNGKey(3) if flip is None else _coin_key(flip)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    ref = float(jax.jit(partial(_jax_loss, jimagen, number))(
        jax.tree_util.tree_map(jnp.asarray, params), key, jin))
    kwargs = {} if flip is None else dict(self_cond_flip=flip)
    with torch.no_grad():
        mine = float(_port_loss(timagen, name, inputs, _jax_draws(jimagen, name, key), **kwargs))
    assert ref > 1e-3
    assert abs(mine - ref) <= 1e-5 * abs(ref)


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('name', ['sr', 'video'])
def test_edm_loss_gradients_match_jax(name, dtype, monkeypatch):
    """Every parameter's gradient of the loss against `jax.grad` of the JAX
    loss on the same inputs. In float64 on both sides (weights, compute and
    the attention softmax; both losses square in fp32) each is within 1e-4
    of the largest gradient. In fp32 the packages' roundings leave the SR
    stage's Perceiver and low-res time embedding up to 2.2e-4 of the largest
    apart, so fp32 is held to `test_torch_gradients.py`'s GRAD_TOL, 1e-3,
    of the largest gradient."""
    f64 = dtype == 'float64'
    if f64:
        softmax_in_input_dtype(monkeypatch)
    with jax.enable_x64(f64):
        jimagen, timagen, params = _cascades(name, dtype)
        inputs = _inputs(name, seed=62, dtype=dtype)
        number = CASES[name][3]
        key = jax.random.PRNGKey(4)
        jin = {k: jnp.asarray(v) for k, v in inputs.items()}
        grads = jax.jit(jax.grad(partial(_jax_loss, jimagen, number)))(
            jax.tree_util.tree_map(jnp.asarray, params), key, jin)
        ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads))
        draws = _jax_draws(jimagen, name, key)
    unet = timagen.unets[number - 1].train()
    _port_loss(timagen, name, inputs, draws).backward()
    largest = max(float(g.abs().max()) for g in ref.values())
    assert largest > 1e-3
    named = dict(unet.named_parameters())
    assert set(named) == set(ref)
    for k, p in named.items():
        assert p.grad.dtype == getattr(torch, dtype)
        assert max_abs(p.grad, ref[k]) <= (1e-4 if f64 else 1e-3) * largest, k


def test_crop_takes_one_window_of_images_and_lowres_with_noise_of_the_cropped_shape():
    """An 8 -> 16 cascade cropping its SR stage to 8 px. Images constant
    over 2 x 2 blocks come through the 16 -> 8 -> 16 degradation unchanged,
    so with zero noise the unet's input (c_in times the cropped images) and
    its low-res condition (the augmentation's alpha times the cropped
    condition) show whether both took the same window; each is an 8 x 8
    window of its own sample. Noise of the uncropped shape is refused, and
    noise drawn by the loss has the cropped one."""
    timagen = it.ElucidatedImagen([it.Unet(**c, device=CPU) for c in (BASE_CFG, SR_CFG)],
                                  image_sizes=(8, 16), random_crop_sizes=(None, 8),
                                  text_embed_dim=16, cond_drop_prob=0., device=CPU)
    r = rng(63)
    images = np.repeat(np.repeat(r.rand(3, 8, 8, 3), 2, axis=1), 2, axis=2).astype(np.float32)
    emb = t(randn(r, 3, 8, 16))
    seen = {}
    unet = timagen.unets[1]
    handle = unet.register_forward_pre_hook(
        lambda m, args, kwargs: seen.update(x=args[0], lowres=kwargs['lowres_cond_img']),
        with_kwargs=True)
    sigmas, aug = torch.tensor([0.5, 1.5, 3.]), torch.tensor([0.3, 0.3, 0.3])
    try:
        with torch.no_grad():
            loss = timagen(t(images), unet_number=2, text_embeds=emb, sigmas=sigmas,
                           noise=torch.zeros(3, 8, 8, 3), lowres_aug_times=aug,
                           lowres_aug_noise=torch.zeros(3, 8, 8, 3),
                           generator=torch.Generator().manual_seed(5))
            assert bool(torch.isfinite(loss))
            c_in = (sigmas ** 2 + 0.5 ** 2) ** -0.5
            cropped = seen['x'] / c_in[:, None, None, None]
            assert cropped.shape == (3, 8, 8, 3)
            alpha_x, *_ = timagen.lowres_noise_schedule.q_sample(cropped, aug,
                                                                 torch.zeros_like(cropped))
            assert max_abs(seen['lowres'], alpha_x) <= 1e-6
            normed = t(images) * 2. - 1.
            for i in range(3):
                assert any(max_abs(cropped[i], normed[i, a:a + 8, b:b + 8]) <= 1e-6
                           for a in range(9) for b in range(9)), i
            with pytest.raises(RuntimeError):   # noise of the uncropped shape
                timagen(t(images), unet_number=2, text_embeds=emb, sigmas=sigmas,
                        noise=torch.zeros(3, 16, 16, 3), generator=torch.Generator())
            timagen(t(images), unet_number=2, text_embeds=emb,
                    generator=torch.Generator().manual_seed(6))
            assert seen['x'].shape == (3, 8, 8, 3) and seen['lowres'].shape == (3, 8, 8, 3)
    finally:
        handle.remove()


@pytest.mark.parametrize('optimizer', ['adam', 'adafactor'])
def test_trainer_trains_an_edm_cascade(optimizer):
    """`ImagenTrainer` takes the EDM loss as `imagen(...)` returns it: the
    loss at fixed draws falls over six steps, the EMA moves, and a video
    cascade trains on clips and on still images."""
    torch.manual_seed(0)
    timagen = it.ElucidatedImagen(it.Unet(**BASE_CFG, device=CPU), image_sizes=(16,),
                                  text_embed_dim=16, device=CPU)
    trainer = it.ImagenTrainer(timagen, lr=1e-3, max_grad_norm=1.0, optimizer=optimizer,
                               ema_update_after_step=0, ema_update_every=1, verbose=False)
    r = rng(64)
    batch = dict(images=t(r.rand(4, 16, 16, 3).astype(np.float32)),
                 text_embeds=t(randn(r, 4, 8, 16)))

    def fixed_loss():
        with torch.no_grad():
            return float(timagen(batch['images'], text_embeds=batch['text_embeds'],
                                 generator=torch.Generator().manual_seed(99)))

    before = fixed_loss()
    losses = [trainer.step_with_batch(batch, max_batch_size=3) for _ in range(6)]
    assert all(np.isfinite(losses)) and fixed_loss() < before
    assert any(not torch.equal(a, b) for a, b in zip(trainer.unets[0].parameters(),
                                                      trainer.ema_unets[0].parameters()))

    video = it.ElucidatedImagen(it.Unet3D(**TINY3D, device=CPU), image_sizes=(8,),
                                text_embed_dim=16, device=CPU)
    trainer = it.ImagenTrainer(video, optimizer=optimizer, verbose=False)
    emb = t(randn(r, 2, 8, 16))
    assert np.isfinite(trainer.step_with_batch(dict(
        images=t(r.rand(2, 4, 8, 8, 3).astype(np.float32)), text_embeds=emb)))
    assert np.isfinite(trainer.step_with_batch(dict(
        images=t(r.rand(2, 8, 8, 3).astype(np.float32)), text_embeds=emb)))
    assert trainer.num_steps_taken(1) == 2
