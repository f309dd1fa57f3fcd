"""The port's video EDM sampler (`ElucidatedImagen` over `Unet3D`) against
the JAX package's, on the CPU, from the same draws.

A one-stage cascade of the dim-8 `Unet3D` at 8 px, 4 frames, 3 churn +
Heun steps (S_churn 80), classifier-free guidance at cond_scale 3, every
draw fed through the JAX `noise_override` dicts at (b, f, s, s, c):
'init', and 'eps' per (step, r). Plain sampling and prompt frames in fp32
to the ROADMAP's 1e-2. Inpainting (`inpaint_videos`, a (b, h, w) mask for
every frame or a (b, f, h, w) one, 2 RePaint resamples a step, the
'repaint' draws too) renoises from sigma_max, where the packages' roundings
spread past 1e-2 even in float64 (the `Unet3D`'s temporal softmax and
temporal conv run in fp32 in both packages), so the sampler is held in
float64 with a float64-exact stand-in for the unet on both sides, to 1e-6,
the known pixels equal to the input after `unnormalize(normalize(.))`; the
real `Unet3D` inpaints too, its known pixels exact. A two-stage cascade with a temporal downsample factor of 2 (the low-res
augmentation draw recomputed as JAX makes it), each stage from the same
input, in fp32. Then the server at `video_frames=4`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_bridge import load_into, max_abs, randn, random_params, rng, t

from imagen_tpu.diffusion.elucidated import ElucidatedImagen as JElucidated
from imagen_tpu.models.unet3d import Unet3D as JUnet3D

import imagen_tpu_torch as it
from imagen_tpu_torch.ops import edm_math as em

CPU = 'cpu'
TINY3D = dict(dim=8, dim_mults=(1, 2), text_embed_dim=16, cond_dim=8, attn_dim_head=4,
              attn_heads=2, attn_pool_num_latents=2, max_text_len=8, layer_attns=False,
              layer_cross_attns=(False, True))
B, FR, S, STEPS = 2, 4, 8, 3


def _params(jimagen, seed):
    out = []
    for i, (unet, size) in enumerate(zip(jimagen.unets, jimagen.image_sizes)):
        x = jnp.zeros((1, 2, size, size, 3))
        ukw = dict(text_embeds=jnp.zeros((1, 8, 16)), text_mask=jnp.ones((1, 8), bool))
        if unet.lowres_cond:
            ukw.update(lowres_cond_img=x, lowres_noise_times=jnp.zeros((1,)))
        out.append(random_params(unet, x, jnp.zeros((1,)), **ukw, seed=seed + i))
    return out


def _cascades(sizes=(S,), factors=1, dtype='float32', seed=90):
    kw = dict(image_sizes=sizes, text_embed_dim=16, num_sample_steps=STEPS, cond_drop_prob=0.1,
              temporal_downsample_factor=factors)
    jimagen = JElucidated(unets=tuple(JUnet3D(**TINY3D, dtype=getattr(jnp, dtype))
                                      for _ in sizes), **kw)
    params = [jax.tree_util.tree_map(lambda a: a.astype(dtype), p)
              for p in _params(jimagen, seed)]
    timagen = it.ElucidatedImagen([it.Unet3D(**TINY3D, dtype=getattr(torch, dtype), device=CPU)
                                   for _ in sizes], device=CPU, **kw)
    for unet, p in zip(timagen.unets, params):   # after the cascade set lowres_cond
        load_into(unet, p).to(getattr(torch, dtype))
    return jimagen, params, timagen


def _text(r):
    mask = np.ones((B, 8), bool)
    mask[0, 6:] = False
    return randn(r, B, 8, 16) * mask[..., None], mask


def _jax_sample(jimagen, params, noise, key=jax.random.PRNGKey(0), **kw):
    return jimagen.sample(tuple({'params': jax.tree_util.tree_map(jnp.asarray, p)}
                                for p in params), key, cond_scale=3., use_tqdm=False,
                          noise_override=[{k: jnp.asarray(v) for k, v in n.items()}
                                          for n in noise],
                          **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                             for k, v in kw.items()})


def _port_sample(timagen, noise, **kw):
    return timagen.sample(cond_scale=3., noise_override=[{k: t(v) for k, v in n.items()}
                                                         for n in noise],
                          **{k: t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})


@pytest.mark.parametrize('prompt', [False, True])
def test_video_samples_match_jax(prompt):
    """Plain sampling, and with two prompt frames before the sampled ones
    (doubled with the batch under guidance)."""
    jimagen, params, timagen = _cascades()
    r = rng(91)
    emb, mask = _text(r)
    noise = [{'init': randn(r, B, FR, S, S, 3), 'eps': randn(r, STEPS, 1, B, FR, S, S, 3)}]
    kw = dict(text_embeds=emb, text_masks=mask, video_frames=FR)
    if prompt:
        kw['cond_video_frames'] = r.rand(B, 2, S, S, 3).astype(np.float32)
    ref = _jax_sample(jimagen, params, noise, **kw)
    out = _port_sample(timagen, noise, **kw)
    assert out.shape == (B, FR, S, S, 3)
    assert max_abs(out, ref) <= 1e-2


class JaxStandIn:
    """A stand-in video denoiser for the JAX sampler, float64-exact in both
    packages: tanh of the clip, the clip one frame later, the time and the
    text's mean (zero where the text is dropped)."""
    self_cond = lowres_cond = False

    def apply(self, variables, x, time, *, text_embeds=None, force_text_drop_mask=None,
              **kwargs):
        text = text_embeds.mean(axis=(1, 2))
        if force_text_drop_mask is not None:
            text = jnp.where(force_text_drop_mask, 0., text)
        return jnp.tanh(0.7 * x + 0.3 * jnp.roll(x, 1, axis=1)
                        + (0.05 * time + 0.2 * text)[:, None, None, None, None])


class TorchStandIn(torch.nn.Module):
    """`JaxStandIn` for the port."""
    self_cond = lowres_cond = False
    is_video_unet = True

    def forward(self, x, time, *, text_embeds=None, force_text_drop_mask=None, **kwargs):
        text = text_embeds.mean(dim=(1, 2))
        if force_text_drop_mask is not None:
            text = torch.where(force_text_drop_mask, 0., text)
        return torch.tanh(0.7 * x + 0.3 * torch.roll(x, 1, dims=1)
                          + (0.05 * time + 0.2 * text)[:, None, None, None, None])


@pytest.mark.parametrize('mask_frames', [False, True])
def test_video_inpainting_matches_jax_in_float64(monkeypatch, mask_frames):
    """Inpainting with 2 RePaint resamples a step, the (b, h, w) mask
    repeated over the frames or a (b, f, h, w) one, guided. RePaint
    renoises from sigma_max and guidance at cond_scale 3 multiplies each
    forward's difference, so the two packages' unets, whose temporal
    softmax and temporal conv compute in fp32 even in a float64 net, end
    0.03-0.4 apart after 3 steps; the sampler is therefore held with a
    float64-exact stand-in for the unet on both sides (the same function of
    the clip, its frames, the time and the guided text drop) and the same
    float64 σ schedule: 1e-6, the known pixels equal to the input after
    `unnormalize(normalize(.))`. `test_video_inpainting_through_unet3d`
    runs the real unet."""
    schedule = em.sample_schedule
    monkeypatch.setattr(em, 'sample_schedule', lambda *a: schedule(*a).astype(np.float64))
    r = rng(92)
    emb, mask = _text(r)
    videos = r.rand(B, FR, S, S, 3)
    masks = r.rand(B, *((FR,) if mask_frames else ()), S, S) < 0.2
    masks[..., :S // 2] = True
    R = 2
    noise = [{'init': r.randn(B, FR, S, S, 3), 'eps': r.randn(STEPS, R, B, FR, S, S, 3),
              'repaint': r.randn(STEPS, R, B, FR, S, S, 3)}]
    kw = dict(text_embeds=emb.astype(np.float64), text_masks=mask, inpaint_videos=videos,
              inpaint_masks=masks, inpaint_resample_times=R)
    sizes = dict(image_sizes=(S,), text_embed_dim=16, num_sample_steps=STEPS,
                 cond_drop_prob=0.1)
    with jax.enable_x64(True):
        jimagen = JElucidated(unets=(JUnet3D(**TINY3D),), **sizes)
        jimagen.unets = (JaxStandIn(),)
        jimagen.sample_schedule = lambda *a: jnp.asarray(em.sample_schedule(*a))
        ref = np.asarray(_jax_sample(jimagen, [{}], noise, **kw))
    timagen = it.ElucidatedImagen((it.Unet3D(**TINY3D, device=CPU),), device=CPU, **sizes)
    timagen.unets[0] = TorchStandIn()
    out = _port_sample(timagen, noise, **kw)
    assert out.dtype == torch.float64 and out.shape == (B, FR, S, S, 3)
    assert max_abs(out, ref) <= 1e-6
    known = masks if mask_frames else np.repeat(masks[:, None], FR, axis=1)
    assert known.any() and (~known).any()
    assert max_abs(out.numpy()[known], ((videos * 2. - 1. + 1.) * 0.5)[known]) <= 1e-12


def test_video_inpainting_through_unet3d():
    """The real `Unet3D`, fp32: the clip comes back at its shape, finite and
    in range, with the known pixels of every frame equal to the input."""
    _, _, timagen = _cascades()
    r = rng(95)
    emb, mask = _text(r)
    videos = t(r.rand(B, FR, S, S, 3).astype(np.float32))
    masks = torch.zeros(B, S, S, dtype=torch.bool)
    masks[..., :S // 2] = True
    out = timagen.sample(text_embeds=t(emb), text_masks=t(mask), cond_scale=3.,
                         inpaint_videos=videos, inpaint_masks=masks, inpaint_resample_times=2,
                         generator=torch.Generator().manual_seed(3))
    assert out.shape == (B, FR, S, S, 3) and bool(torch.isfinite(out).all())
    known = masks[:, None].expand(B, FR, S, S)
    assert max_abs(out[known], ((videos * 2. - 1. + 1.) * 0.5)[known]) <= 1e-6


def test_two_stage_video_cascade_matches_jax():
    """4 -> 8 px, the first stage at half the frames (temporal downsample
    factor 2): stage 1 of the cascade, and stage 2 started from JAX's
    stage-1 clip, its low-res augmentation draw recomputed as JAX makes it
    (`fold_in(key, 1000 + 1)` at the stage's clip shape)."""
    jimagen, params, timagen = _cascades(sizes=(4, S), factors=(2, 1))
    r = rng(93)
    emb, mask = _text(r)
    noise = [{'init': randn(r, B, FR // 2, 4, 4, 3),
              'eps': randn(r, STEPS, 1, B, FR // 2, 4, 4, 3)},
             {'init': randn(r, B, FR, S, S, 3), 'eps': randn(r, STEPS, 1, B, FR, S, S, 3)}]
    key = jax.random.PRNGKey(0)
    kw = dict(text_embeds=emb, text_masks=mask, video_frames=FR)
    ref = _jax_sample(jimagen, params, noise, key, return_all_unet_outputs=True, **kw)
    lowres = np.asarray(jax.random.normal(jax.random.fold_in(key, 1000 + 1), (B, FR, S, S, 3)))
    low, _ = _port_sample(timagen, noise, return_all_unet_outputs=True, **kw)
    assert low.shape == (B, FR // 2, 4, 4, 3)
    assert max_abs(low, ref[0]) <= 1e-2
    override = [{k: t(v) for k, v in n.items()} for n in noise]
    override[1]['lowres'] = t(lowres)
    up = timagen.sample(cond_scale=3., noise_override=override, start_at_unet_number=2,
                        start_image_or_video=t(np.asarray(ref[0])),
                        **{k: t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    assert up.shape == (B, FR, S, S, 3)
    assert max_abs(up, ref[1]) <= 1e-2


def test_server_serves_a_video_edm_cascade():
    _, _, timagen = _cascades()
    server = it.ImagenServer(timagen, batch_size=2, text_len=8, cond_scale=3., video_frames=FR,
                             seed=1)
    emb, _ = _text(rng(94))
    emb = t(emb[:1])
    video = server.generate(text_embeds=emb, generator=torch.Generator().manual_seed(5))
    assert video.shape == (1, FR, S, S, 3)
    assert np.isfinite(video).all() and video.min() >= 0. and video.max() <= 1.
    padded, masks, _ = server._pad_request(emb, (emb != 0).any(-1))
    direct = timagen.sample(text_embeds=padded, text_masks=masks, cond_scale=3.,
                            video_frames=FR, generator=torch.Generator().manual_seed(5))
    assert max_abs(video, direct[:1]) == 0.
