"""The port's EDM cascade (`ElucidatedImagen`) against the JAX package.

`edm_math` to 1e-6; the preconditioned denoiser (classifier-free guidance,
dynamic thresholding) to 1e-4; a tiny 16 -> 32 cascade (the dim-8 base and
SR configs, 3 + 2 steps, S_churn 80, cond_scale 3, dynamic thresholding,
low-res noise augmentation) sampled by JAX with `noise_override` {'init',
'eps'} and by the port with the same draws plus the low-res augmentation
draw recomputed as JAX makes it, each stage to 1e-2 from the same input;
the same with per-call sigma_min/sigma_max and `stop_at_unet_number`; the
whole cascade end to end in float64 on both sides to 1e-6; a one-stage dim-128 cascade
with `fused_film=True` against JAX under `IMAGEN_TPU_FUSED_FILM=1`; the
server around the EDM class; and what is not ported raising (T5 text
encoding), beside the EDM training loss that now runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_bridge import BASE_CFG, SR_CFG, StandInEncoder, inject_t5, jparams, load_into, \
    max_abs, randn, random_params, rng, softmax_in_input_dtype, t

import imagen_tpu.ops.edm_math as jem
from imagen_tpu.diffusion.elucidated import ElucidatedImagen as JElucidated
from imagen_tpu.models.unet2d import Unet as JUnet

import imagen_tpu_torch as it
from imagen_tpu_torch.ops import edm_math as em

SIZES, STEPS = (16, 32), (3, 2)


def test_edm_math_matches_jax():
    sigma = np.array([1e-14, 0.002, 0.3, 2.5, 80.], np.float32)
    for name in ('c_skip', 'c_out', 'c_in'):
        ref = getattr(jem, name)(0.5, jnp.asarray(sigma))
        assert max_abs(getattr(em, name)(0.5, t(sigma)), ref) <= 1e-6, name
    assert max_abs(em.c_noise(t(sigma)), jem.c_noise(jnp.asarray(sigma))) <= 1e-6
    assert max_abs(np.array([em.c_noise(s) for s in sigma]), jem.c_noise(jnp.asarray(sigma))) \
        <= 1e-6
    weights = em.loss_weight(0.5, t(sigma[1:]))
    assert max_abs(weights, jem.loss_weight(0.5, jnp.asarray(sigma[1:]))) <= 1e-6 * 1e6  # λ(0.002)
    for steps, rho, lo, hi in ((32, 7., 0.002, 80.), (3, 7., 0.01, 40.), (8, 5., 0.002, 160.)):
        sigmas = em.sample_schedule(steps, rho, lo, hi)
        ref = jem.sample_schedule(steps, rho, lo, hi)
        assert sigmas.dtype == np.float32 and sigmas.shape == (steps + 1,) and sigmas[-1] == 0.
        assert max_abs(sigmas, ref) <= 1e-6 * hi
        gammas = em.gammas_for_schedule(sigmas, steps, 80., 0.05, 50.)
        assert max_abs(gammas, jem.gammas_for_schedule(ref, steps, 80., 0.05, 50.)) == 0.
    draws = em.noise_distribution(-1.2, 1.2, 5, generator=torch.Generator().manual_seed(0))
    assert draws.shape == (5,) and bool((draws > 0).all())


@pytest.fixture(scope='module')
def cascades():
    junets = (JUnet(**BASE_CFG), JUnet(**SR_CFG))
    kw = dict(image_sizes=SIZES, text_embed_dim=16, num_sample_steps=STEPS, cond_drop_prob=0.1)
    jimagen = JElucidated(unets=junets, **kw)
    params = []
    for i, (unet, size) in enumerate(zip(jimagen.unets, SIZES)):
        x, time = jnp.zeros((1, size, size, 3)), jnp.zeros((1,))
        ukw = dict(text_embeds=jnp.zeros((1, 8, 16)), text_mask=jnp.ones((1, 8), bool))
        if unet.lowres_cond:
            ukw.update(lowres_cond_img=x, lowres_noise_times=time)
        params.append(random_params(unet, x, time, **ukw, seed=40 + i))
    tunets = [load_into(it.Unet(**cfg, device='cpu'), p)
              for cfg, p in zip((BASE_CFG, SR_CFG), params)]
    return jimagen, params, it.ElucidatedImagen(tunets, **kw, device='cpu')


def _text(seed, b=2):
    r = rng(seed)
    mask = np.ones((b, 8), bool)
    mask[0, 6:] = False
    return randn(r, b, 8, 16) * mask[..., None], mask


def test_preconditioned_forward_matches_jax(cascades):
    jimagen, params, timagen = cascades
    emb, mask = _text(50)
    r = rng(51)
    x = randn(r, 2, 16, 16, 3, scale=3.)
    sigma = np.array([2.5, 0.3], np.float32)
    kw = dict(sigma_data=0.5, clamp=True, dynamic_threshold=True, cond_scale=3.)

    @jax.jit
    def ref(p, x, sigma, emb, mask):
        return jimagen.preconditioned_network_forward(
            jimagen.unets[0], {'params': p}, x, sigma, text_embeds=emb, text_mask=mask, **kw)

    args = (jnp.asarray(x), jnp.asarray(sigma), jnp.asarray(emb), jnp.asarray(mask))
    expected = ref(jax.tree_util.tree_map(jnp.asarray, params[0]), *args)
    mine = timagen.preconditioned_network_forward(
        timagen.unets[0], t(x), t(sigma), text_embeds=t(emb), text_mask=t(mask), **kw)
    assert max_abs(mine, expected) <= 1e-4
    # one sigma for the whole batch: the coefficients as host floats
    same = np.full((2,), 2.5, np.float32)
    expected = ref(jax.tree_util.tree_map(jnp.asarray, params[0]), args[0], jnp.asarray(same),
                   *args[2:])
    mine = timagen.preconditioned_network_forward(
        timagen.unets[0], t(x), 2.5, text_embeds=t(emb), text_mask=t(mask), **kw)
    assert max_abs(mine, expected) <= 1e-4


def _noise(seed, b=2, stages=2):
    r = rng(seed)
    return [{'init': randn(r, b, s, s, 3), 'eps': randn(r, n, 1, b, s, s, 3)}
            for s, n in list(zip(SIZES, STEPS))[:stages]]


def _jax_sample(jimagen, params, emb, mask, noise, **kw):
    key = jax.random.PRNGKey(0)
    out = jimagen.sample(
        tuple(jparams(p) for p in params), key, text_embeds=jnp.asarray(emb),
        text_masks=jnp.asarray(mask), cond_scale=3., use_tqdm=False,
        noise_override=[{k: jnp.asarray(v) for k, v in n.items()} for n in noise], **kw)
    # the low-res augmentation draw of stage 2, as JAX makes it (elucidated.py:545)
    lowres = np.asarray(jax.random.normal(jax.random.fold_in(key, 1000 + 1),
                                          (emb.shape[0], SIZES[1], SIZES[1], 3)))
    return out, lowres


def _port_override(noise, lowres=None):
    override = [{k: t(v) for k, v in n.items()} for n in noise]
    if lowres is not None:
        override[1]['lowres'] = t(lowres)
    return override


def test_cascade_samples_match_jax(cascades):
    """Each stage from the same input: stage 1 of the whole cascade, and stage
    2 started from JAX's stage-1 image. The two packages' fp32 roundings
    leave stage 1 about 1.5e-3 apart, and the random SR stage at cond_scale
    3 amplifies that to 5e-2 at the cascade's end, so the end is not held to
    1e-2 through stage 1's rounding; the float64 test below shows that gap
    is rounding alone."""
    jimagen, params, timagen = cascades
    emb, mask = _text(52)
    noise = _noise(53)
    ref, lowres = _jax_sample(jimagen, params, emb, mask, noise, return_all_unet_outputs=True)
    override = _port_override(noise, lowres)
    low, _ = timagen.sample(text_embeds=t(emb), text_masks=t(mask), cond_scale=3.,
                            noise_override=override, return_all_unet_outputs=True)
    assert low.shape == (2, SIZES[0], SIZES[0], 3)
    assert max_abs(low, ref[0]) <= 1e-2
    up = timagen.sample(text_embeds=t(emb), text_masks=t(mask), cond_scale=3.,
                        noise_override=override, start_at_unet_number=2,
                        start_image_or_video=t(np.asarray(ref[0])))
    assert up.shape == (2, SIZES[1], SIZES[1], 3)
    assert max_abs(up, ref[1]) <= 1e-2


def test_cascade_end_to_end_in_float64_matches_jax(cascades, monkeypatch):
    """The whole cascade, stage 2 from each package's own stage 1, in float64
    on both sides (float64 weights, compute, noise and softmax; the same
    float32 sigma schedule, as float64, on both sides). The packages then
    agree to 1e-11, where in fp32 the samples end 5e-2 apart: the gap of the
    fp32 run is rounding that the random SR stage amplifies, not a different
    op."""
    _, params, _ = cascades
    softmax_in_input_dtype(monkeypatch)
    schedule = em.sample_schedule
    monkeypatch.setattr(em, 'sample_schedule',
                        lambda *a: schedule(*a).astype(np.float64))
    emb, mask = _text(52)
    noise = _noise(53)
    kw = dict(image_sizes=SIZES, text_embed_dim=16, num_sample_steps=STEPS, cond_drop_prob=0.1)
    key = jax.random.PRNGKey(0)
    with jax.enable_x64(True):
        junets = (JUnet(**BASE_CFG, dtype=jnp.float64), JUnet(**SR_CFG, dtype=jnp.float64))
        jimagen = JElucidated(unets=junets, **kw)
        jimagen.sample_schedule = lambda *a: jnp.asarray(em.sample_schedule(*a))
        f64 = lambda a: jnp.asarray(np.asarray(a, np.float64))  # noqa: E731
        ref = jimagen.sample(
            tuple({'params': jax.tree_util.tree_map(f64, p)} for p in params), key,
            text_embeds=f64(emb), text_masks=jnp.asarray(mask), cond_scale=3.,
            use_tqdm=False, noise_override=[{k: f64(v) for k, v in n.items()} for n in noise],
            return_all_unet_outputs=True)
        lowres = np.asarray(jax.random.normal(jax.random.fold_in(key, 1000 + 1),
                                              (2, SIZES[1], SIZES[1], 3)))
    assert lowres.dtype == np.float64
    tunets = [load_into(it.Unet(**cfg, dtype=torch.float64, device='cpu'), p).double()
              for cfg, p in zip((BASE_CFG, SR_CFG), params)]
    timagen = it.ElucidatedImagen(tunets, **kw, device='cpu')
    override = [{k: torch.from_numpy(v.astype(np.float64)) for k, v in n.items()} for n in noise]
    override[1]['lowres'] = torch.from_numpy(lowres.copy())
    low, up = timagen.sample(text_embeds=torch.from_numpy(emb.astype(np.float64)),
                             text_masks=t(mask), cond_scale=3., noise_override=override,
                             return_all_unet_outputs=True)
    assert up.dtype == torch.float64 and up.shape == (2, SIZES[1], SIZES[1], 3)
    assert max_abs(low, ref[0]) <= 1e-6
    assert max_abs(up, ref[1]) <= 1e-6


def test_sigma_overrides_and_stop_match_jax(cascades):
    jimagen, params, timagen = cascades
    emb, mask = _text(54)
    noise = _noise(55, stages=1)
    kw = dict(sigma_min=0.01, sigma_max=40., stop_at_unet_number=1)
    ref, _ = _jax_sample(jimagen, params, emb, mask, noise + [{}], **kw)
    out = timagen.sample(text_embeds=t(emb), text_masks=t(mask), cond_scale=3.,
                         noise_override=_port_override(noise) + [None], **kw)
    assert out.shape == (2, SIZES[0], SIZES[0], 3)
    assert max_abs(out, ref) <= 1e-2


def test_stop_then_start_gives_the_full_sample(cascades):
    _, _, timagen = cascades
    emb, _ = _text(56)
    override = _port_override(_noise(57), randn(rng(58), 2, SIZES[1], SIZES[1], 3))
    low, full = timagen.sample(text_embeds=t(emb), cond_scale=3., noise_override=override,
                               return_all_unet_outputs=True)
    assert low.shape == (2, SIZES[0], SIZES[0], 3)
    up = timagen.sample(text_embeds=t(emb), cond_scale=3., noise_override=override,
                        start_at_unet_number=2, start_image_or_video=low)
    assert max_abs(up, full) == 0.


FILM_CFG = dict(dim=128, dim_mults=(1, 2), num_resnet_blocks=1, layer_attns=(False, True),
                layer_cross_attns=(False, True), attn_heads=2, attn_dim_head=16,
                text_embed_dim=16, cond_dim=32, max_text_len=8, attn_pool_num_latents=4,
                learned_sinu_pos_emb_dim=4)


def test_fused_film_cascade_matches_jax(monkeypatch):
    """One dim-128 stage at 8 x 8, 3 steps, with every Block on the fused
    route: `fused_film=True` in the port, `IMAGEN_TPU_FUSED_FILM=1` in JAX."""
    monkeypatch.setenv('IMAGEN_TPU_FUSED_FILM', '1')
    kw = dict(image_sizes=(8,), text_embed_dim=16, num_sample_steps=3, cond_drop_prob=0.1)
    jimagen = JElucidated(unets=(JUnet(**FILM_CFG),), **kw)
    x, time = jnp.zeros((1, 8, 8, 3)), jnp.zeros((1,))
    p = random_params(jimagen.unets[0], x, time, text_embeds=jnp.zeros((1, 8, 16)),
                      text_mask=jnp.ones((1, 8), bool), seed=60)
    emb, mask = _text(61)
    r = rng(62)
    noise = [{'init': randn(r, 2, 8, 8, 3), 'eps': randn(r, 3, 1, 2, 8, 8, 3)}]
    ref = jimagen.sample((jparams(p),), jax.random.PRNGKey(0), text_embeds=jnp.asarray(emb),
                         text_masks=jnp.asarray(mask), cond_scale=3., use_tqdm=False,
                         noise_override=[{k: jnp.asarray(v) for k, v in noise[0].items()}])
    timagen = it.ElucidatedImagen(
        (load_into(it.Unet(**FILM_CFG, fused_film=True, device='cpu'), p),), **kw, device='cpu')
    out = timagen.sample(text_embeds=t(emb), text_masks=t(mask), cond_scale=3.,
                         noise_override=_port_override(noise))
    assert max_abs(out, ref) <= 1e-2


def test_server_serves_the_edm_cascade(cascades):
    _, _, timagen = cascades
    server = it.ImagenServer(timagen, batch_size=2, text_len=8, cond_scale=3., seed=1)
    emb, _ = _text(63, b=1)
    images = server.generate(text_embeds=t(emb), generator=torch.Generator().manual_seed(5))
    assert images.shape == (1, SIZES[1], SIZES[1], 3)
    assert np.isfinite(images).all() and images.min() >= 0. and images.max() <= 1.
    padded, masks, n = server._pad_request(t(emb), (t(emb) != 0).any(-1))
    direct = timagen.sample(text_embeds=padded, text_masks=masks, cond_scale=3.,
                            generator=torch.Generator().manual_seed(5))
    assert max_abs(images, direct[:1]) == 0.


def test_what_is_not_ported_raises(cascades, monkeypatch):
    _, _, timagen = cascades
    emb = t(_text(64)[0])
    # raw texts go through the cascade's T5 encoder (a stand-in here)
    inject_t5(monkeypatch, StandInEncoder(16), name=timagen.text_encoder_name)
    texts = ['a prompt']
    by_text = timagen.sample(texts=texts, cond_scale=3.,
                             generator=torch.Generator().manual_seed(2))
    text_embeds, text_masks = timagen.encode_text(texts, return_attn_mask=True)
    by_embeds = timagen.sample(text_embeds=text_embeds, text_masks=text_masks, cond_scale=3.,
                               generator=torch.Generator().manual_seed(2))
    assert by_text.shape == (1, SIZES[1], SIZES[1], 3) and max_abs(by_text, by_embeds) == 0.
    with pytest.raises(ValueError):   # the RePaint draws need a (step, r) axis pair
        timagen.sample(text_embeds=emb, noise_override=[{'repaint': torch.zeros(1)}, None])
    with pytest.raises(ValueError):   # the churn draws need a resample axis
        timagen.sample(text_embeds=emb, noise_override=[
            {'eps': torch.zeros(STEPS[0], 2, 16, 16, 3)}, None])
    with pytest.raises(ValueError):
        timagen.sample(text_embeds=emb, noise_override=[{'init_noise': torch.zeros(1)}, None])
    # EDM training is ported: the loss is a finite scalar
    loss = timagen(torch.zeros(2, 16, 16, 3), unet_number=1, text_embeds=emb,
                   generator=torch.Generator().manual_seed(0))
    assert loss.ndim == 0 and bool(torch.isfinite(loss))


def test_without_a_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip('a GPU is present')
    unet = it.Unet(**BASE_CFG, device='cpu')
    with pytest.raises(RuntimeError):
        it.ElucidatedImagen((unet,), image_sizes=(16,), text_embed_dim=16)
