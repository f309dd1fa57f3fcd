"""The port's video training path against the JAX package, fp32 on the CPU.

At a small size with one level at c = 128, so that two temporal sites take
the fused LayerNorm fold and out-norm unfold (kernels 12 and 13; their plain
versions here): `Unet3D` with `temporal_fused_ln` on and off, forward and
every parameter's gradient, against the JAX `Unet3D` with
`IMAGEN_TPU_TEMPORAL_FUSED_LN` on (Pallas in interpret mode) and off.
`Imagen.forward` is held to JAX's on what it hands `p_losses` (the clips
resized to the stage's frames, the low-res condition resized down and back
up in space and time, the scaled prompt frames, `ignore_time` for still
images), and `p_losses` to JAX's with the same times, noise and low-res
noise, 1e-5 relative, for a one-stage cascade and the SR stage of a
two-stage cascade with a temporal downsample factor. Then the per-frame
paired crop, a few trainer steps, sampling with prompt frames against the
JAX sampler (1e-2), and one state_dict on both routes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_bridge import jparams, load_into, max_abs, randn, random_params, rng, t

import imagen_tpu.ops.temporal_layout as jtl
from imagen_tpu.diffusion.imagen import Imagen as JImagen
from imagen_tpu.models.unet3d import Unet3D as JUnet3D

import imagen_tpu_torch as it
from imagen_tpu_torch.diffusion.imagen import _per_sample_random_crop
from imagen_tpu_torch.ops import temporal_layout as tl
from imagen_tpu_torch.utils.port_weights import state_dict_from_jax

CPU = 'cpu'
# channels 16 and 128: the temporal sites of the middle and of the first up
# level pass the fused route's c >= 128 (a down level attends before its
# channels grow)
SMALL = dict(dim=16, dim_mults=(1, 8), text_embed_dim=16, cond_dim=8, attn_dim_head=4,
             attn_heads=2, attn_pool_num_latents=2, max_text_len=8, layer_attns=False,
             layer_cross_attns=(False, True))
FUSED_SITES = 2
B, FR, S = 2, 4, 8
# fp32 rounding through a random net moves a gradient by up to ~1e-4 of its
# tensor's largest entry; global-context key biases have an exact-zero
# gradient, so each tensor's scale is floored at 1e-5 of the largest
GRAD_TOL = 1e-4


def _text(r, b):
    mask = np.ones((b, 8), bool)
    mask[0, 5:] = False
    return randn(r, b, 8, 16) * mask[..., None], mask


def _count_fused(monkeypatch):
    calls = []
    fused = tl.fused_norm_untranspose

    def counted(*args):
        calls.append(args[1].shape)
        return fused(*args)
    monkeypatch.setattr(tl, 'fused_norm_untranspose', counted)
    return calls


@pytest.mark.parametrize('fused', [True, False], ids=['fused', 'unfused'])
def test_unet3d_forward_and_gradients_match_jax(monkeypatch, fused):
    monkeypatch.setenv('IMAGEN_TPU_TEMPORAL_FUSED_LN', '1' if fused else '0')
    monkeypatch.setattr(jtl, '_INTERPRET', fused)
    r = rng(70)
    x, time = randn(r, B, FR, S, S, 3), r.rand(B).astype(np.float32)
    emb, mask = _text(r, B)
    cot = randn(r, B, FR, S, S, 3)
    kw = dict(text_embeds=emb, text_mask=mask)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    junet = JUnet3D(**SMALL)
    params = random_params(junet, jnp.asarray(x), jnp.asarray(time), seed=71, **jkw)

    def jloss(p):
        out = junet.apply({'params': p}, jnp.asarray(x), jnp.asarray(time), **jkw)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, ref), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams(params)['params'])
    ref_grads = state_dict_from_jax(grads, video=True)

    calls = _count_fused(monkeypatch)
    unet = load_into(it.Unet3D(**SMALL, temporal_fused_ln=fused, device=CPU), params)
    out = unet(t(x), t(time), **{k: t(v) for k, v in kw.items()})
    (out * t(cot)).sum().backward()
    assert len(calls) == (FUSED_SITES if fused else 0)
    assert max_abs(out, ref) <= 1e-4
    named = dict(unet.named_parameters())
    assert set(named) == set(ref_grads)
    largest = max(float(g.abs().max()) for g in ref_grads.values())
    for k, p in named.items():
        scale = max(float(ref_grads[k].abs().max()), 1e-5 * largest)
        assert max_abs(p.grad, ref_grads[k]) <= GRAD_TOL * scale, k


# --- Imagen.forward and p_losses ----------------------------------------------------------

CASES = {
    # one stage: clips with two preceding prompt frames
    'one_stage': dict(sizes=(8,), factors=1, unet=1, frames=4, cond_frames=2),
    # one stage: still images, trained as one-frame clips with ignore_time
    'stills': dict(sizes=(8,), factors=1, unet=1, frames=None, cond_frames=None),
    # the SR stage of 2 frames at 8 px -> 4 frames at 16 px
    'sr_temporal': dict(sizes=(8, 16), factors=(2, 1), unet=2, frames=4, cond_frames=None),
}


def _cascades(case, cond_drop_prob=0.):
    sizes = case['sizes']
    kw = dict(image_sizes=sizes, text_embed_dim=16, cond_drop_prob=cond_drop_prob, timesteps=4,
              temporal_downsample_factor=case['factors'])
    jimagen = JImagen(unets=tuple(JUnet3D(**SMALL) for _ in sizes), **kw)
    timagen = it.Imagen([it.Unet3D(**SMALL, temporal_fused_ln=True, device=CPU)
                         for _ in sizes], device=CPU, **kw)
    index = case['unet'] - 1
    x, time = jnp.zeros((1, 2, sizes[index], sizes[index], 3)), jnp.zeros((1,))
    ukw = dict(text_embeds=jnp.zeros((1, 8, 16)), text_mask=jnp.ones((1, 8), bool))
    if index > 0:
        ukw.update(lowres_cond_img=x, lowres_noise_times=time)
    params = random_params(jimagen.unets[index], x, time, **ukw, seed=80 + index)
    load_into(timagen.unets[index], params)
    return jimagen, timagen, index, params


def _p_losses_inputs(imagen, call):
    """What `forward` hands `p_losses`: the call's positional and keyword
    arguments, with p_losses stubbed out."""
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


@pytest.mark.parametrize('name', list(CASES))
def test_forward_and_p_losses_match_jax(monkeypatch, name):
    monkeypatch.setenv('IMAGEN_TPU_TEMPORAL_FUSED_LN', '1')
    monkeypatch.setattr(jtl, '_INTERPRET', True)
    case = CASES[name]
    jimagen, timagen, index, params = _cascades(case)
    size = case['sizes'][-1]
    r = rng(90)
    frames = case['frames']
    shape = (B, size, size, 3) if frames is None else (B, frames, size, size, 3)
    images = r.rand(*shape).astype(np.float32)
    emb, mask = _text(r, B)
    call = dict(text_embeds=emb, text_masks=mask)
    if case['cond_frames']:
        call['cond_video_frames'] = r.rand(B, case['cond_frames'], size, size, 3).astype(
            np.float32)

    key = jax.random.PRNGKey(3)
    (_, _, jx, _, _), jkw = _p_losses_inputs(jimagen, lambda: jimagen.forward(
        jparams(params), jnp.asarray(images), key, unet_number=index + 1,
        **{k: jnp.asarray(v) for k, v in call.items()}))
    (_, tx, _), tkw = _p_losses_inputs(timagen, lambda: timagen(
        t(images), unet_number=index + 1, generator=torch.Generator().manual_seed(0),
        **{k: t(v) for k, v in call.items()}))

    # the same clips, low-res condition and prompt frames reach the loss
    assert max_abs(tx, jx) == 0.
    assert tx.ndim == 5 and (frames is not None or tkw['ignore_time'])
    assert bool(tkw['ignore_time']) == bool(jkw.get('ignore_time', False))
    for k in ('lowres_cond_img', 'cond_video_frames'):
        assert (tkw.get(k) is None) == (jkw.get(k) is None), k
        if tkw.get(k) is not None:
            assert max_abs(tkw[k], jkw[k]) <= 1e-6, k

    # both losses on those inputs with the same times and noise
    times = np.asarray([0.15, 0.8], np.float32)
    noise = randn(r, *np.shape(jx))
    lowres = {}
    if index > 0:
        lowres = dict(lowres_cond_img=np.asarray(jkw['lowres_cond_img']),
                      lowres_aug_times=np.asarray([0.3, 0.05], np.float32))
    frames_kw = {k: np.asarray(jkw[k]) for k in ('cond_video_frames',) if k in jkw}
    static = {k: jkw[k] for k in ('ignore_time',) if k in jkw}
    junet = jimagen.unets[index]

    def jloss(p, x, times, noise, text_embeds, text_mask, extra):
        return jimagen.p_losses(
            junet, {'params': p}, x, times, key,
            noise_scheduler=jimagen.noise_schedulers[index], text_embeds=text_embeds,
            text_mask=text_mask, noise=noise, pred_objective=jimagen.pred_objectives[index],
            min_snr_gamma=jimagen.min_snr_gamma[index], **extra, **static)

    extra = {**lowres, **frames_kw}
    ref = float(jax.jit(jloss)(jparams(params)['params'], *map(jnp.asarray, (
        np.asarray(jx), times, noise, emb, mask)), {k: jnp.asarray(v) for k, v in extra.items()}))
    if index > 0:
        # JAX draws the low-res augmentation noise from the third key of its split
        lrk = jax.random.split(key, 6)[2]
        extra['lowres_aug_noise'] = np.asarray(jax.random.normal(lrk, jx.shape))
    with torch.no_grad():
        mine = float(timagen.p_losses(
            timagen.unets[index], tx, t(times), noise_scheduler=timagen.noise_schedulers[index],
            text_embeds=t(emb), text_mask=t(mask), noise=t(noise),
            pred_objective=timagen.pred_objectives[index],
            min_snr_gamma=timagen.min_snr_gamma[index], **static,
            **{k: t(v) for k, v in extra.items()}))
    assert ref > 1e-3
    assert abs(mine - ref) <= 1e-5 * abs(ref)


def test_video_crop_is_per_frame_and_paired():
    """Each frame of each clip gets its own window, the same in x, noise
    and the low-res condition; an SR stage trains on such crops."""
    r = rng(11)
    x = t(randn(r, 3, 4, 16, 16, 3))
    cx, cn, cl = _per_sample_random_crop((x, x * 2. + 1., x - 3.), 8,
                                         torch.Generator().manual_seed(0))
    assert cx.shape == (3, 4, 8, 8, 3)
    assert torch.equal(cn, cx * 2. + 1.) and torch.equal(cl, cx - 3.)
    offsets = set()
    for i in range(3):
        for f in range(4):
            found = [(a, b) for a in range(9) for b in range(9)
                     if torch.equal(cx[i, f], x[i, f, a:a + 8, b:b + 8])]
            assert found, (i, f)
            offsets.add(found[0])
    assert len(offsets) > 1   # drawn per frame, not once per clip

    timagen = it.Imagen([it.Unet3D(**SMALL, lowres_cond=i > 0, device=CPU) for i in range(2)],
                        image_sizes=(8, 16), random_crop_sizes=(None, 8), text_embed_dim=16,
                        timesteps=4, device=CPU)
    emb, _ = _text(r, 2)
    loss = timagen(t(r.rand(2, 4, 16, 16, 3).astype(np.float32)), unet_number=2,
                   text_embeds=t(emb), generator=torch.Generator().manual_seed(1))
    assert loss.ndim == 0 and bool(torch.isfinite(loss))


def test_trainer_steps_on_video_lower_the_loss():
    """A tiny video cascade on the fused route: six steps on one batch lower
    its loss at fixed draws and move the EMA; batches of clips split along
    the batch axis (ragged), still images pass `ignore_time` to every chunk."""
    imagen = it.Imagen(it.Unet3D(**SMALL, temporal_fused_ln=True, device=CPU),
                       image_sizes=(8,), text_embed_dim=16, timesteps=4, cond_drop_prob=0.1,
                       device=CPU)
    trainer = it.ImagenTrainer(imagen, lr=1e-3, max_grad_norm=1.0, ema_update_after_step=0,
                               ema_update_every=1, verbose=False)
    r = rng(12)
    emb, mask = _text(r, 3)
    batch = dict(images=t(r.rand(3, FR, S, S, 3).astype(np.float32)), text_embeds=t(emb),
                 text_masks=t(mask))

    def fixed_loss():
        with torch.no_grad():
            return float(imagen(batch['images'], text_embeds=batch['text_embeds'],
                                generator=torch.Generator().manual_seed(99)))

    before = fixed_loss()
    losses = [trainer.step_with_batch(batch, max_batch_size=2) for _ in range(6)]
    assert all(np.isfinite(losses))
    assert fixed_loss() < before
    online, ema_unet = trainer.unets[0], trainer.ema_unets[0]
    assert any(not torch.equal(a, b) for a, b in zip(online.parameters(),
                                                      ema_unet.parameters()))
    stills = dict(images=t(r.rand(3, S, S, 3).astype(np.float32)), text_embeds=t(emb))
    assert np.isfinite(trainer.step_with_batch(stills, ignore_time=True, max_batch_size=2))
    assert trainer.num_steps_taken(1) == 7
    video = trainer.sample(text_embeds=t(emb[:2]), video_frames=FR,
                           cond_video_frames=t(r.rand(2, 2, S, S, 3).astype(np.float32)))
    assert video.shape == (2, FR, S, S, 3) and bool(torch.isfinite(video).all())


def test_sample_with_prompt_frames_matches_jax(monkeypatch):
    """One stage, 3 steps, classifier-free guidance (the prompt frames are
    doubled with the batch), the same initial and step noise in both."""
    monkeypatch.setenv('IMAGEN_TPU_TEMPORAL_FUSED_LN', '1')
    monkeypatch.setattr(jtl, '_INTERPRET', True)
    jimagen, timagen, _, params = _cascades(dict(sizes=(8,), factors=1, unet=1),
                                            cond_drop_prob=0.1)
    r = rng(13)
    emb, mask = _text(r, B)
    prompt = r.rand(B, 2, S, S, 3).astype(np.float32)
    steps = 4
    noise = (randn(r, B, FR, S, S, 3), randn(r, steps, B, FR, S, S, 3))
    ref = jimagen.sample((jparams(params),), jax.random.PRNGKey(0),
                         text_embeds=jnp.asarray(emb), text_masks=jnp.asarray(mask),
                         video_frames=FR, cond_video_frames=jnp.asarray(prompt), cond_scale=3.,
                         noise_override=[tuple(map(jnp.asarray, noise))], use_tqdm=False)
    out = timagen.sample(text_embeds=t(emb), text_masks=t(mask), video_frames=FR,
                         cond_video_frames=t(prompt), cond_scale=3.,
                         noise_override=[(t(noise[0]), t(noise[1]), None)])
    assert out.shape == (B, FR, S, S, 3)
    assert max_abs(out, ref) <= 1e-2


def test_one_state_dict_loads_on_both_routes():
    plain = it.Unet3D(**SMALL, device=CPU)
    fused = it.Unet3D(**SMALL, temporal_fused_ln=True, device=CPU)
    assert plain.state_dict().keys() == fused.state_dict().keys()
    fused.load_state_dict(plain.state_dict(), strict=True)
    plain.load_state_dict(fused.state_dict(), strict=True)
    assert 'mid_temporal_attn.fn.fn.to_out.1.g' in fused.state_dict()
    # the cascade's cast keeps the route
    sr = fused.cast_model_parameters(lowres_cond=True, text_embed_dim=16, channels=3,
                                     channels_out=None, cond_on_text=True)
    assert sr.lowres_cond and sr.mid_temporal_attn.fused_ln
    assert not plain.mid_temporal_attn.fused_ln
