"""The methods that close the port's public surface, against `imagen_tpu`.

Same weights through `state_dict_from_jax`, same noise through
`noise_override`, at the tiny sizes of the other port tests:
- `forward_with_cond_scale` of `Unet` and `Unet3D` at cond_scale 3, fp32,
  to 1e-4 of the output's largest value (see the test); the lerp of the
  port's own halves bit for bit; at cond_scale 1, the plain forward;
- `force_unconditional_`: samples of a 16 -> 32 DDPM cascade and of a
  one-stage EDM cascade at cond_scale 1 and 3, against JAX's after its own
  `force_unconditional_` (1e-2) and, bit for bit, against a cascade built
  with `condition_on_text=False` that loads the same weights non-strictly;
  the forced cascade's state_dict still loads strictly;
- `get_unet`, `has_cond_image` and `channels_out_` values, exactly;
- `ElucidatedImagen.sample_schedule` and `loss_weight` to 1e-6;
  `noise_distribution` from a seeded generator is exp(P_mean + P_std *
  randn) from that generator;
- `predict_v_from_start_and_noise` to 1e-6, and bit for bit the v target
  that `p_losses` computed from `q_sample`'s alpha and sigma;
- `block_on`, `StepTimer.measure` and `trace` (its file holds the
  `annotate` span) on the CPU.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_bridge import jparams, load_into, max_abs, randn, \
    random_params, rng, t

from imagen_tpu.diffusion.elucidated import ElucidatedImagen as JElucidated
from imagen_tpu.diffusion.imagen import Imagen as JImagen
from imagen_tpu.models.unet2d import NullUnet as JNullUnet, Unet as JUnet
from imagen_tpu.models.unet3d import Unet3D as JUnet3D
from imagen_tpu.ops.diffusion_math import GaussianDiffusionContinuousTimes as JGaussian

import imagen_tpu_torch as it
from imagen_tpu_torch.ops.diffusion_math import GaussianDiffusionContinuousTimes
from imagen_tpu_torch.utils.profiling import StepTimer, annotate, block_on, trace

CPU = 'cpu'
SIZES, STEPS = (16, 32), (3, 2)
# one resnet block a level, cross-attention at the second: every text module
# (projection, attention pooling, null embed and hidden, cross-attention
# context) is on the forward, at a fraction of the JAX compile time of the
# shared BASE_CFG and SR_CFG (torch_port_bridge)
SMALL = dict(dim=8, dim_mults=(1, 2), text_embed_dim=16, cond_dim=8, attn_dim_head=4,
             attn_heads=2, attn_pool_num_latents=2, max_text_len=8, layer_attns=False,
             layer_cross_attns=(False, True), num_resnet_blocks=1,
             learned_sinu_pos_emb_dim=4)
SMALL_SR = dict(SMALL, lowres_cond=True, memory_efficient=True)


def _unet_inputs(video, seed, b=2, size=8, frames=4):
    r = rng(seed)
    x = randn(r, b, *((frames,) if video else ()), size, size, 3)
    mask = np.ones((b, 6), bool)
    mask[0, 4:] = False
    kw = dict(text_embeds=randn(r, b, 6, 16) * mask[..., None], text_mask=mask)
    return x, r.rand(b).astype(np.float32), kw


@pytest.mark.parametrize('video', [False, True], ids=['unet', 'unet3d'])
def test_forward_with_cond_scale_matches_jax(video, cond_scale=3.):
    """The guided output against JAX's method to 1e-4 of its largest value:
    the lerp takes the halves' fp32 rounding (held to 1e-4 on their own in
    `test_torch_self_cond.py`) times up to 2 * cond_scale - 1, and these
    random weights take the output to about 40. The port's method is the
    free function and the lerp of its own doubled forward, bit for bit; at
    cond_scale 1, the plain forward."""
    x, time, kw = _unet_inputs(video, seed=3)
    junet = (JUnet3D if video else JUnet)(**SMALL)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    params = random_params(junet, jnp.asarray(x), jnp.asarray(time), seed=5, **jkw)
    ref = jax.jit(lambda v, x, tm, kw: junet.forward_with_cond_scale(
        v, x, tm, cond_scale=cond_scale, **kw))(jparams(params), jnp.asarray(x),
                                                 jnp.asarray(time), jkw)
    unet = load_into((it.Unet3D if video else it.Unet)(**SMALL, device=CPU), params)
    tkw = {k: t(v) for k, v in kw.items()}
    b = x.shape[0]
    with torch.no_grad():
        out = unet.forward_with_cond_scale(t(x), t(time), cond_scale=cond_scale, **tkw)
        free = it.diffusion.unet_forward_with_cond_scale(unet, t(x), t(time),
                                                        cond_scale=cond_scale, **tkw)
        halves = unet(torch.cat((t(x), t(x))), torch.cat((t(time), t(time))),
                      force_text_drop_mask=torch.arange(2 * b) >= b,
                      **{k: torch.cat((v, v)) for k, v in tkw.items()})
        plain = unet.forward_with_cond_scale(t(x), t(time), **tkw)
        assert torch.equal(plain, unet(t(x), t(time), **tkw))
    assert out.shape == x.shape
    assert max_abs(out, ref) <= 1e-4 * float(np.abs(np.asarray(ref)).max())
    assert torch.equal(out, free)
    assert torch.equal(out, halves[b:] + (halves[:b] - halves[b:]) * cond_scale)


def _cascade(kind):
    """(JAX cascade, its params, port cascade, port kwargs, port unet configs):
    the DDPM 16 -> 32 cascade or the one-stage EDM cascade."""
    if kind == 'ddpm':
        cfgs, sizes = (SMALL, SMALL_SR), SIZES
        kw = dict(image_sizes=sizes, text_embed_dim=16, timesteps=STEPS, cond_drop_prob=0.1)
        jklass, klass = JImagen, it.Imagen
    else:
        cfgs, sizes = (SMALL,), SIZES[:1]
        kw = dict(image_sizes=sizes, text_embed_dim=16, num_sample_steps=STEPS[0],
                  cond_drop_prob=0.1)
        jklass, klass = JElucidated, it.ElucidatedImagen
    jimagen = jklass(unets=tuple(JUnet(**c) for c in cfgs), **kw)
    params = []
    for i, (unet, size) in enumerate(zip(jimagen.unets, sizes)):
        x, time = jnp.zeros((1, size, size, 3)), jnp.zeros((1,))
        ukw = dict(text_embeds=jnp.zeros((1, 8, 16)), text_mask=jnp.ones((1, 8), bool))
        if unet.lowres_cond:
            ukw.update(lowres_cond_img=x, lowres_noise_times=time)
        params.append(random_params(unet, x, time, **ukw, seed=60 + i))
    timagen = klass([load_into(it.Unet(**c, device=CPU), p) for c, p in zip(cfgs, params)],
                    **kw, device=CPU)
    return jimagen, params, timagen, klass, kw, cfgs


@pytest.fixture(scope='module', params=['ddpm', 'edm'])
def forced(request):
    """Both packages' cascades after `force_unconditional_`, and a port
    cascade built with `condition_on_text=False` that loaded the forced
    one's weights non-strictly."""
    jimagen, params, timagen, klass, kw, cfgs = _cascade(request.param)
    jimagen.force_unconditional_()
    timagen.force_unconditional_()
    plain = klass([it.Unet(**c, device=CPU) for c in cfgs],
                  **{**kw, 'condition_on_text': False}, device=CPU)
    result = plain.load_state_dict(timagen.state_dict(), strict=False)
    assert not result.missing_keys and result.unexpected_keys
    return request.param, jimagen, params, timagen, plain.eval()


def _sample_both(kind, jimagen, params, cond_scale, b=2):
    """JAX's sample and the port's override of the same draws."""
    r = rng(70)
    sizes, key = jimagen.image_sizes, jax.random.PRNGKey(0)
    if kind == 'ddpm':
        noise = [(randn(r, b, s, s, 3), randn(r, n, b, s, s, 3)) for s, n in zip(sizes, STEPS)]
        joverride = [tuple(map(jnp.asarray, n)) for n in noise]
    else:
        noise = [{'init': randn(r, b, sizes[0], sizes[0], 3),
                  'eps': randn(r, STEPS[0], 1, b, sizes[0], sizes[0], 3)}]
        joverride = [{k: jnp.asarray(v) for k, v in n.items()} for n in noise]
    ref = jimagen.sample(tuple(jparams(p) for p in params), key, batch_size=b,
                         cond_scale=cond_scale, noise_override=joverride, use_tqdm=False)
    if kind == 'ddpm':
        # the low-res aug noise of stage 2, as JAX draws it (imagen.py:707-710)
        lowres = np.asarray(jax.random.normal(jax.random.fold_in(key, 1000 + 1),
                                              (b, sizes[1], sizes[1], 3)))
        override = [(t(noise[0][0]), t(noise[0][1]), None),
                    (t(noise[1][0]), t(noise[1][1]), t(lowres))]
    else:
        override = [{k: t(v) for k, v in n.items()} for n in noise]
    return ref, override


@pytest.mark.parametrize('cond_scale', [1., 3.])
def test_force_unconditional_samples_match_jax_and_an_unconditional_cascade(forced,
                                                                            cond_scale):
    kind, jimagen, params, timagen, plain = forced
    assert not timagen.condition_on_text and timagen.unconditional
    assert all(not u.cond_on_text for u in timagen.unets)
    ref, override = _sample_both(kind, jimagen, params, cond_scale)
    out = timagen.sample(batch_size=2, cond_scale=cond_scale, noise_override=override,
                         use_tqdm=False)
    size = jimagen.image_sizes[-1]
    assert out.shape == (2, size, size, 3)
    assert max_abs(out, ref) <= 1e-2
    same = plain.sample(batch_size=2, cond_scale=cond_scale, noise_override=override,
                        use_tqdm=False)
    assert torch.equal(out, same)
    with pytest.raises(ValueError, match='unconditional'):
        timagen.sample(text_embeds=torch.zeros(2, 8, 16), noise_override=override)


def test_forced_cascade_keeps_its_weights_and_loads_strictly(forced):
    _, _, params, timagen, _ = forced
    fresh = load_into(it.Unet(**SMALL, device=CPU), params[0])
    for k, v in fresh.state_dict().items():
        assert torch.equal(timagen.unets[0].state_dict()[k], v), k
    timagen.unets[0].load_state_dict(fresh.state_dict(), strict=True)
    assert timagen.unets[0]._config['cond_on_text'] is False
    # the flag, not the modules' presence, keeps text out of the forward
    x, time, kw = _unet_inputs(False, seed=11, size=SIZES[0])
    with torch.no_grad():
        assert torch.equal(timagen.unets[0](t(x), t(time), **{k: t(v) for k, v in kw.items()}),
                           timagen.unets[0](t(x), t(time)))
        assert not torch.equal(fresh(t(x), t(time), **{k: t(v) for k, v in kw.items()}),
                               fresh(t(x), t(time)))


def test_get_unet_and_unet_properties_match_jax():
    jcfg = dict(SMALL, cond_images_channels=2, channels_out=4)
    pairs = [(JUnet(**SMALL), it.Unet(**SMALL, device=CPU)),
             (JUnet(**jcfg), it.Unet(**jcfg, device=CPU)),
             (JUnet3D(**SMALL, channels=1), it.Unet3D(**SMALL, channels=1, device=CPU)),
             (JUnet3D(**SMALL, cond_images_channels=3),
              it.Unet3D(**SMALL, cond_images_channels=3, device=CPU)),
             (JNullUnet(channels=1), it.NullUnet(channels=1, device=CPU))]
    for junet, unet in pairs:
        assert (unet.has_cond_image, unet.channels_out_) == \
            (junet.has_cond_image, junet.channels_out_), type(unet).__name__
    assert it.Unet3D(**SMALL, temporal_strides=(2, 2), device=CPU).total_temporal_divisor \
        == JUnet3D(**SMALL, temporal_strides=(2, 2)).total_temporal_divisor == 4

    junets = (JNullUnet(), JUnet(**SMALL_SR))
    jimagen = JImagen(unets=junets, image_sizes=SIZES, text_embed_dim=16, timesteps=STEPS)
    timagen = it.Imagen((it.NullUnet(device=CPU), it.Unet(**SMALL_SR, device=CPU)),
                        image_sizes=SIZES, text_embed_dim=16, timesteps=STEPS, device=CPU)
    for n in (1, 2):
        assert type(timagen.get_unet(n)).__name__ == type(jimagen.get_unet(n)).__name__
        assert timagen.get_unet(n) is timagen.unets[n - 1]
    for n in (0, 3):
        with pytest.raises(AssertionError):
            jimagen.get_unet(n)
        with pytest.raises(ValueError):
            timagen.get_unet(n)


def test_edm_methods_match_jax():
    kw = dict(image_sizes=SIZES[:1], text_embed_dim=16, num_sample_steps=STEPS[0])
    jimagen = JElucidated(unets=(JNullUnet(),), **kw)
    timagen = it.ElucidatedImagen((it.NullUnet(device=CPU),), **kw, device=CPU)
    for steps, rho, lo, hi in ((32, 7., 0.002, 80.), (3, 5., 0.01, 160.)):
        sigmas = timagen.sample_schedule(steps, rho, lo, hi)
        assert sigmas.shape == (steps + 1,)
        assert max_abs(sigmas, jimagen.sample_schedule(steps, rho, lo, hi)) <= 1e-6 * hi
    sigma = np.array([0.002, 0.3, 2.5, 80.], np.float32)
    weights = timagen.loss_weight(0.5, t(sigma))
    ref = np.asarray(jimagen.loss_weight(0.5, jnp.asarray(sigma)))
    assert float(np.abs(weights.numpy() / ref - 1).max()) <= 1e-6   # λ(0.002) is 2.5e5

    draws = timagen.noise_distribution(-1.2, 1.2, 5, generator=torch.Generator().manual_seed(3))
    expected = torch.exp(-1.2 + 1.2 * torch.randn((5,), generator=torch.Generator().manual_seed(3)))
    assert draws.device.type == CPU and torch.equal(draws, expected)
    jdraws = jimagen.noise_distribution(jax.random.PRNGKey(0), -1.2, 1.2, 5)
    assert jdraws.shape == draws.shape


@pytest.mark.parametrize('schedule', ['cosine', 'linear'])
def test_predict_v_from_start_and_noise_matches_jax(schedule):
    r = rng(9)
    x, noise = randn(r, 3, 4, 4, 3), randn(r, 3, 4, 4, 3)
    times = np.array([0.05, 0.5, 0.95], np.float32)
    mine = GaussianDiffusionContinuousTimes(noise_schedule=schedule, timesteps=10)
    v = mine.predict_v_from_start_and_noise(t(x), t(times), t(noise))
    ref = JGaussian(noise_schedule=schedule, timesteps=10).predict_v_from_start_and_noise(
        jnp.asarray(x), jnp.asarray(times), jnp.asarray(noise))
    assert max_abs(v, ref) <= 1e-6
    # the target p_losses formed from q_sample's alpha and sigma, bit for bit
    _, _, alpha, sigma = mine.q_sample(t(x), t(times), t(noise))
    assert torch.equal(v, alpha * t(noise) - sigma * t(x))


def test_profiling_helpers_on_the_cpu(tmp_path):
    tree = {'a': torch.ones(3), 'b': [torch.zeros(2), (torch.arange(4), 'text')], 'c': 1}
    assert block_on(tree) is tree
    timer = StepTimer(window=4)
    for _ in range(2):
        with timer.measure(CPU):
            torch.ones(8).sum()
    summary = timer.summary()
    assert summary['n'] == 2 and summary['mean_s'] >= 0.

    with trace(tmp_path):
        with annotate('surface_span'):
            torch.randn(32, 32) @ torch.randn(32, 32)
    files = list(tmp_path.glob('*.pt.trace.json'))
    assert len(files) == 1
    names = {e.get('name') for e in json.loads(files[0].read_text())['traceEvents']}
    assert 'surface_span' in names
