"""Inpainting (RePaint), `init_images` + `skip_steps` and the other sampling
keywords of the port against the JAX package.

The tiny 16 -> 32 cascade of `test_torch_cascade.py` (dim-8 base and SR
unets, 3 + 2 DDPM steps, classifier-free guidance at cond_scale 3) inpaints
a 32 px image with a half-image mask and 2 RePaint resamples a step, every
draw fed through `noise_override` (the low-res augmentation draw
recomputed as JAX makes it); each stage's sample agrees to 1e-2 and the
known pixels equal the input after `unnormalize(normalize(.))` to 1e-6.
The same for `init_images` with `skip_steps`, a per-call
`lowres_sample_noise_level` and `return_all_unet_outputs`; for a one-stage
video cascade inpainting 4 frames with one (b, h, w) mask (the EDM
sampler's are in `test_torch_inpaint_edm.py`). Then every keyword that used to raise runs,
what is still unported raises, and the server's keywords.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_bridge import BASE_CFG, SR_CFG, StandInEncoder, inject_t5, jparams, load_into, \
    max_abs, randn, random_params, rng, t

from imagen_tpu.diffusion.imagen import Imagen as JImagen
from imagen_tpu.models.unet2d import Unet as JUnet
from imagen_tpu.models.unet3d import Unet3D as JUnet3D
from imagen_tpu.ops.tensor_utils import resize_image_to as jresize

import imagen_tpu_torch as it

SIZES, STEPS, R, B = (16, 32), (3, 2), 2, 2
KEY = jax.random.PRNGKey(0)


def _params(junets, sizes, seed, frames=None):
    params = []
    for i, (unet, size) in enumerate(zip(junets, sizes)):
        shape = (1, size, size, 3) if frames is None else (1, frames, size, size, 3)
        x, time = jnp.zeros(shape), jnp.zeros((1,))
        kw = dict(text_embeds=jnp.zeros((1, 8, 16)), text_mask=jnp.ones((1, 8), bool))
        if unet.lowres_cond:
            kw.update(lowres_cond_img=x, lowres_noise_times=time)
        params.append(random_params(unet, x, time, **kw, seed=seed + i))
    return params


@pytest.fixture(scope='module')
def ddpm():
    kw = dict(image_sizes=SIZES, text_embed_dim=16, timesteps=STEPS, cond_drop_prob=0.1)
    jimagen = JImagen(unets=(JUnet(**BASE_CFG), JUnet(**SR_CFG)), **kw)
    params = _params(jimagen.unets, SIZES, seed=70)
    tunets = [load_into(it.Unet(**cfg, device='cpu'), p) for cfg, p in zip((BASE_CFG, SR_CFG),
                                                                           params)]
    return jimagen, tuple(jparams(p) for p in params), it.Imagen(tunets, device='cpu', **kw)


def _text(r, b=B):
    mask = np.ones((b, 8), bool)
    mask[0, 6:] = False
    return randn(r, b, 8, 16) * mask[..., None], mask


def _inpaint(r, size=SIZES[-1], b=B, frames=None):
    """Images in [0, 1] and a mask, True where the pixels are known: the left
    half of every sample, plus a random scatter."""
    lead = (b,) if frames is None else (b, frames)
    images = r.rand(*lead, size, size, 3).astype(np.float32)
    mask = r.rand(b, size, size) < 0.2
    mask[:, :, :size // 2] = True
    return images, mask


def _lowres(shape):
    """Stage 2's low-res augmentation draw, as JAX makes it (imagen.py:707-710)."""
    return np.asarray(jax.random.normal(jax.random.fold_in(KEY, 1000 + 1), shape))


def _known(images, size):
    """The known pixels a stage must return: the input resized to the stage
    and put through normalize then unnormalize, in fp32."""
    x = np.asarray(jresize(jnp.asarray(images), size))
    return (x * 2. - 1. + 1.) * 0.5


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_ddpm_inpainting_matches_jax(ddpm):
    jimagen, params, timagen = ddpm
    r = rng(71)
    emb, mask = _text(r)
    images, masks = _inpaint(r)
    noise = [tuple(randn(r, *lead, B, s, s, 3) for lead in ((), (n, R), (n, R), (n, R)))
             for s, n in zip(SIZES, STEPS)]
    ref = jimagen.sample(params, KEY, text_embeds=jnp.asarray(emb), text_masks=jnp.asarray(mask),
                         cond_scale=3., inpaint_images=jnp.asarray(images),
                         inpaint_masks=jnp.asarray(masks), inpaint_resample_times=R,
                         noise_override=_j(noise), return_all_unet_outputs=True, use_tqdm=False)
    override = [dict(zip(('init', 'inpaint', 'steps', 'renoise'), map(t, n))) for n in noise]
    override[1]['lowres'] = t(_lowres((B, SIZES[1], SIZES[1], 3)))
    outs = timagen.sample(text_embeds=t(emb), text_masks=t(mask), cond_scale=3.,
                          inpaint_images=t(images), inpaint_masks=t(masks),
                          inpaint_resample_times=R, noise_override=override,
                          return_all_unet_outputs=True)
    for out, expected, size in zip(outs, ref, SIZES):
        assert out.shape == (B, size, size, 3)
        assert max_abs(out, expected) <= 1e-2
        known = np.asarray(jresize(jnp.asarray(masks[..., None].astype(np.float32)),
                                   size)).astype(bool)[..., 0]
        assert known.any() and (~known).any()
        assert max_abs(out.numpy()[known], _known(images, size)[known]) <= 1e-6
        assert max_abs(np.asarray(expected)[known], _known(images, size)[known]) <= 1e-6


def test_ddpm_init_images_skip_steps_and_lowres_level_match_jax(ddpm):
    jimagen, params, timagen = ddpm
    r = rng(72)
    emb, mask = _text(r)
    init = r.rand(B, SIZES[1], SIZES[1], 3).astype(np.float32)
    skip = 1
    noise = [(randn(r, B, s, s, 3), randn(r, n - skip, B, s, s, 3))
             for s, n in zip(SIZES, STEPS)]
    kw = dict(cond_scale=3., skip_steps=skip, lowres_sample_noise_level=0.35,
              return_all_unet_outputs=True)
    ref = jimagen.sample(params, KEY, text_embeds=jnp.asarray(emb), text_masks=jnp.asarray(mask),
                         init_images=jnp.asarray(init), noise_override=_j(noise), use_tqdm=False,
                         **kw)
    override = [(t(n[0]), t(n[1]), None) for n in noise]
    override[1] = (*override[1][:2], t(_lowres((B, SIZES[1], SIZES[1], 3))))
    outs = timagen.sample(text_embeds=t(emb), text_masks=t(mask), init_images=t(init),
                          noise_override=override, **kw)
    assert isinstance(outs, list) and len(outs) == 2
    for out, expected, size in zip(outs, ref, SIZES):
        assert out.shape == (B, size, size, 3)
        assert max_abs(out, expected) <= 1e-2
    # the per-call level is the one used: the cascade's own gives another image
    other = timagen.sample(text_embeds=t(emb), text_masks=t(mask), init_images=t(init),
                           noise_override=override, **{**kw, 'lowres_sample_noise_level': None})
    assert max_abs(other[1], outs[1]) > 1e-4 and max_abs(other[0], outs[0]) == 0.
    with pytest.raises(ValueError):   # step noise for every step, not those left
        timagen.sample(text_embeds=t(emb), skip_steps=skip, noise_override=[
            (t(noise[0][0]), t(randn(r, STEPS[0], B, 16, 16, 3)), None), None])


def test_video_inpainting_with_one_mask_for_every_frame_matches_jax():
    tiny = dict(dim=8, dim_mults=(1, 2), text_embed_dim=16, cond_dim=8, attn_dim_head=4,
                attn_heads=2, attn_pool_num_latents=2, max_text_len=8, layer_attns=False,
                layer_cross_attns=(False, True))
    kw = dict(image_sizes=(8,), text_embed_dim=16, timesteps=3, cond_drop_prob=0.1)
    jimagen = JImagen(unets=(JUnet3D(**tiny),), **kw)
    params = _params(jimagen.unets, (8,), seed=90, frames=2)
    timagen = it.Imagen((load_into(it.Unet3D(**tiny, device='cpu'), params[0]),),
                        device='cpu', **kw)
    r = rng(91)
    emb, mask = _text(r)
    frames, steps = 4, 3
    videos, masks = _inpaint(r, size=8, frames=frames)
    shape = (B, frames, 8, 8, 3)
    noise = (randn(r, *shape), *(randn(r, steps, R, *shape) for _ in range(3)))
    ref = jimagen.sample(tuple(jparams(p) for p in params), KEY, text_embeds=jnp.asarray(emb),
                         text_masks=jnp.asarray(mask), cond_scale=3.,
                         inpaint_videos=jnp.asarray(videos), inpaint_masks=jnp.asarray(masks),
                         inpaint_resample_times=R, noise_override=[_j(noise)], use_tqdm=False)
    out = timagen.sample(text_embeds=t(emb), text_masks=t(mask), cond_scale=3.,
                         inpaint_videos=t(videos), inpaint_masks=t(masks),
                         inpaint_resample_times=R, noise_override=[
                             dict(zip(('init', 'inpaint', 'steps', 'renoise'), map(t, noise)))])
    assert out.shape == shape
    assert max_abs(out, ref) <= 1e-2
    known = np.broadcast_to(masks[:, None], (B, frames, 8, 8))
    assert max_abs(out.numpy()[known], ((videos * 2. - 1. + 1.) * 0.5)[known]) <= 1e-6


# --- every keyword that used to raise -----------------------------------------------------

TINY = dict(BASE_CFG, num_resnet_blocks=1, layer_attns=False, layer_cross_attns=False)
TINY3D = dict(dim=8, dim_mults=(1, 2), text_embed_dim=16, cond_dim=8, attn_dim_head=4,
              attn_heads=2, attn_pool_num_latents=2, max_text_len=8, layer_attns=False,
              layer_cross_attns=False)


def _tiny(kind, **unet_kw):
    if kind == 'video':
        return it.Imagen((it.Unet3D(**TINY3D, **unet_kw, device='cpu'),), image_sizes=(8,),
                         text_embed_dim=16, timesteps=2, device='cpu')
    cls = it.ElucidatedImagen if kind == 'edm' else it.Imagen
    steps = dict(num_sample_steps=2) if kind == 'edm' else dict(timesteps=2)
    return cls((it.Unet(**TINY, **unet_kw, device='cpu'),), image_sizes=(8,),
               text_embed_dim=16, device='cpu', **steps)


CALLS = {
    'inpaint_images': dict(inpaint_images=torch.rand(2, 8, 8, 3),
                           inpaint_masks=torch.rand(2, 8, 8) < 0.5, inpaint_resample_times=2),
    'init_images_skip_steps': dict(init_images=torch.rand(2, 8, 8, 3), skip_steps=1),
    'cond_images': dict(cond_images=(torch.rand(2, 4, 4, 3) * 255).to(torch.uint8)),
    'lowres_level_all_outputs': dict(lowres_sample_noise_level=0.1,
                                     return_all_unet_outputs=True),
    'pil_images': dict(return_pil_images=True),
    'repaint_override': dict(inpaint_images=torch.rand(2, 8, 8, 3),
                             inpaint_masks=torch.rand(2, 8, 8) < 0.5, inpaint_resample_times=2,
                             noise_override=[{'repaint': torch.randn(2, 2, 2, 8, 8, 3)}]),
    'self_cond': {},
    'inpaint_videos': dict(inpaint_videos=torch.rand(2, 2, 8, 8, 3),
                           inpaint_masks=torch.rand(2, 8, 8) < 0.5, inpaint_resample_times=2),
}
CASES = [(kind, name) for kind in ('ddpm', 'edm') for name in CALLS
         if name != 'inpaint_videos' and not (kind == 'ddpm' and name == 'repaint_override')]
CASES += [('video', 'inpaint_videos'), ('video', 'self_cond'), ('video', 'cond_images')]


@pytest.mark.parametrize('kind,name', CASES)
def test_every_keyword_that_raised_now_runs(kind, name):
    unet_kw = {'cond_images': dict(cond_images_channels=3),
               'self_cond': dict(self_cond=True)}.get(name, {})
    imagen = _tiny(kind, **unet_kw)
    call = dict(CALLS[name])
    if kind == 'video':
        call.setdefault('video_frames', 2)
    out = imagen.sample(text_embeds=torch.randn(2, 8, 16), cond_scale=3.,
                        generator=torch.Generator().manual_seed(0), **call)
    if name == 'pil_images':
        assert len(out) == 2 and out[0].size == (8, 8)
        return
    if name == 'lowres_level_all_outputs':
        assert isinstance(out, list) and len(out) == 1
        out = out[0]
    assert out.shape == ((2, 2, 8, 8, 3) if kind == 'video' else (2, 8, 8, 3))
    assert bool(torch.isfinite(out).all()) and 0. <= float(out.min()) <= float(out.max()) <= 1.
    if 'inpaint_masks' in call:
        known = call['inpaint_masks'][:, None] if kind == 'video' else call['inpaint_masks']
        known = known.expand(out.shape[:-1])
        source = call.get('inpaint_videos', call.get('inpaint_images'))
        assert max_abs(out[known], ((source * 2 - 1 + 1) * 0.5)[known]) <= 1e-6


def test_unconditional_inpainting_takes_its_batch_from_the_images():
    unet = it.Unet(**{**TINY, 'cond_on_text': False}, device='cpu')
    imagen = it.Imagen((unet,), image_sizes=(8,), timesteps=2, condition_on_text=False,
                       device='cpu')
    masks = torch.rand(3, 8, 8) < 0.5
    out = imagen.sample(inpaint_images=torch.rand(3, 8, 8, 3), inpaint_masks=masks,
                        inpaint_resample_times=2, generator=torch.Generator().manual_seed(0))
    assert out.shape == (3, 8, 8, 3)


def test_what_is_still_unported_raises(monkeypatch):
    emb = torch.randn(2, 8, 16)
    for imagen in (_tiny('ddpm'), _tiny('edm')):
        # raw texts go through the cascade's T5 encoder (a stand-in here)
        inject_t5(monkeypatch, StandInEncoder(16), name=imagen.text_encoder_name)
        text_embeds, text_masks = imagen.encode_text(['a prompt'], return_attn_mask=True)
        assert torch.equal(
            imagen.sample(texts=['a prompt'], generator=torch.Generator().manual_seed(1)),
            imagen.sample(text_embeds=text_embeds, text_masks=text_masks,
                          generator=torch.Generator().manual_seed(1)))
        with pytest.raises(ValueError):   # images without masks
            imagen.sample(text_embeds=emb, inpaint_images=torch.rand(2, 8, 8, 3))
        with pytest.raises(ValueError):   # a unet without cond channels
            imagen.sample(text_embeds=emb, cond_images=torch.rand(2, 8, 8, 3))
        with pytest.raises(ValueError):
            imagen.sample(text_embeds=emb, noise_override=[{'renoise_noise': torch.zeros(1)}])
    with pytest.raises(ValueError):   # cond channels and no cond images
        _tiny('ddpm', cond_images_channels=3).sample(text_embeds=emb)
    # the options that used to raise here build (test_torch_unet_options.py,
    # test_torch_remat.py and test_torch_resize.py hold them to JAX); an
    # unknown resize method raises
    it.Unet(**TINY, cross_embed_downsample=True, device='cpu')
    it.Unet(**TINY, cond_images_channels=3, resize_mode='bilinear', device='cpu')
    for ported in (dict(remat=True), dict(dropout=0.1)):
        it.Unet3D(**TINY3D, **ported, device='cpu')
    it.ElucidatedImagen((it.Unet3D(**TINY3D, device='cpu'),), image_sizes=(8,),
                        text_embed_dim=16, resize_cond_video_frames=False, device='cpu')
    with pytest.raises(ValueError):
        it.Unet(**TINY, cond_images_channels=3, resize_mode='area', device='cpu')
    with pytest.raises(ValueError):
        it.ElucidatedImagen((it.Unet3D(**TINY3D, device='cpu'),), image_sizes=(8,),
                            text_embed_dim=16, resize_mode='area', device='cpu')


# --- the server's keywords --------------------------------------------------------------

def test_server_keywords(ddpm):
    _, _, timagen = ddpm
    seen = []
    sample = timagen.sample

    def spy(**kwargs):
        seen.append((kwargs['cond_scale'], kwargs['lowres_sample_noise_level']))
        return sample(**kwargs)

    timagen.sample = spy
    try:
        server = it.ImagenServer(timagen, batch_size=2, text_len=8, cond_scales=(3., 5.),
                                 lowres_sample_noise_level=0.3, warmup=False)
        assert not seen and server.cond_scales == (3., 5.)
        server.warmup()
        assert seen == [(3., 0.3), (5., 0.3)]
        emb = t(randn(rng(73), 1, 8, 16))
        images = server.generate(text_embeds=emb, cond_scale=5.,
                                 generator=torch.Generator().manual_seed(4))
        assert seen[-1] == (5., 0.3)
        padded, masks, _ = server._pad_request(emb, (emb != 0).any(-1))
        direct = sample(text_embeds=padded, text_masks=masks, cond_scale=5.,
                        lowres_sample_noise_level=0.3, generator=torch.Generator().manual_seed(4))
        assert max_abs(images, direct[:1]) == 0.
        server.generate(text_embeds=emb)
        assert seen[-1] == (3., 0.3)   # the server's own cond_scale by default
        assert it.ImagenServer(timagen, batch_size=2, text_len=8, warmup=False).cond_scales \
            == (3.,)
    finally:
        del timagen.sample
