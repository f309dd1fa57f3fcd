"""The SR-1024 tail's shape of cascade in the port against the JAX package:
`tests/test_cascade_3stage.py`'s `BASE` config, fp32, on the CPU.

A three-stage 4 -> 8 -> 16 cascade (memory-efficient pixel-shuffle SR
stages, 3 DDPM steps each, cond_scale 2) sampled by JAX with
`noise_override` and by the port with the same noise and the low-res
augmentation draws recomputed as JAX makes them: 1e-2. A `NullUnet` first
stage: the SR stage's `p_losses` (1e-5 relative) and sampling from
`start_at_unet_number=2` (1e-2). `offload_inactive_unets=True` gives the
plain sample, for DDPM and EDM, and puts a parked unet back as it was. The
weights bridge is strict both ways on a dim-8 `SRUnet1024`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_bridge import jparams, load_into, max_abs, randn, random_params, rng, t

from imagen_tpu.diffusion.imagen import Imagen as JImagen
from imagen_tpu.models.unet2d import NullUnet as JNullUnet
from imagen_tpu.models.unet2d import SRUnet1024 as JSRUnet1024
from imagen_tpu.models.unet2d import Unet as JUnet
from imagen_tpu_torch.diffusion.imagen import on_device
from imagen_tpu_torch.utils.port_weights import state_dict_from_jax

import imagen_tpu_torch as it

CPU = 'cpu'
# tests/test_cascade_3stage.py's BASE, with a 4-wide time embedding as the port's tests use
BASE = dict(dim=8, dim_mults=(1, 2), text_embed_dim=16, cond_dim=8, attn_dim_head=4,
            attn_heads=2, attn_pool_num_latents=2, max_text_len=8, layer_attns=False,
            layer_cross_attns=(False, True), learned_sinu_pos_emb_dim=4)
SR = dict(BASE, memory_efficient=True, pixel_shuffle_upsample=True)
SIZES, STEPS = (4, 8, 16), (3, 3, 3)
KEY = jax.random.PRNGKey(0)


def _params(jimagen, index, seed):
    unet, size = jimagen.unets[index], jimagen.image_sizes[index]
    x, time = jnp.zeros((1, size, size, 3)), jnp.zeros((1,))
    kw = dict(text_embeds=jnp.zeros((1, 8, 16)), text_mask=jnp.ones((1, 8), bool))
    if unet.lowres_cond:
        kw.update(lowres_cond_img=x, lowres_noise_times=time)
    return random_params(unet, x, time, **kw, seed=seed)


@pytest.fixture(scope='module')
def three_stage():
    kw = dict(image_sizes=SIZES, text_embed_dim=16, timesteps=STEPS, cond_drop_prob=0.1)
    jimagen = JImagen(unets=(JUnet(**BASE), JUnet(**SR), JUnet(**SR)), **kw)
    params = [_params(jimagen, i, 70 + i) for i in range(3)]
    timagen = it.Imagen([it.Unet(**BASE, device=CPU), it.Unet(**SR, device=CPU),
                         it.Unet(**SR, device=CPU)], **kw, device=CPU)
    for unet, p in zip(timagen.unets, params):
        load_into(unet, p)
    return jimagen, params, timagen


def _text(seed, b=2):
    r = rng(seed)
    mask = np.ones((b, 8), bool)
    mask[1, 5:] = False
    return randn(r, b, 8, 16) * mask[..., None], mask


def _lowres_draw(index, b=2):
    """The low-res augmentation noise of stage `index`, as JAX draws it
    (`imagen_tpu/diffusion/imagen.py:709`)."""
    size = SIZES[index]
    return t(np.asarray(jax.random.normal(jax.random.fold_in(KEY, 1000 + index),
                                          (b, size, size, 3))))


def test_three_stage_samples_match_jax(three_stage):
    jimagen, params, timagen = three_stage
    emb, mask = _text(71)
    r = rng(72)
    noise = [(randn(r, 2, s, s, 3), randn(r, n, 2, s, s, 3)) for s, n in zip(SIZES, STEPS)]
    ref = jimagen.sample(tuple(jparams(p) for p in params), KEY, text_embeds=jnp.asarray(emb),
                         text_masks=jnp.asarray(mask), cond_scale=2., use_tqdm=False,
                         noise_override=[tuple(map(jnp.asarray, n)) for n in noise])
    override = [(t(n[0]), t(n[1]), None if i == 0 else _lowres_draw(i))
                for i, n in enumerate(noise)]
    out = timagen.sample(text_embeds=t(emb), text_masks=t(mask), cond_scale=2.,
                         noise_override=override)
    assert out.shape == (2, 16, 16, 3)
    assert float(np.asarray(ref).std()) > 0.05   # not a clamped constant
    assert max_abs(out, ref) <= 1e-2


def test_offload_inactive_unets_gives_the_plain_sample(three_stage):
    _, _, timagen = three_stage
    emb, mask = _text(73)
    kw = dict(text_embeds=t(emb), text_masks=t(mask), cond_scale=2.)
    plain = timagen.sample(**kw, generator=torch.Generator().manual_seed(3))
    offloaded = timagen.sample(**kw, offload_inactive_unets=True,
                               generator=torch.Generator().manual_seed(3))
    assert torch.equal(plain, offloaded)


def test_on_device_puts_a_parked_unet_back():
    """A unet parked off the cascade's device is moved there for the block
    and holds its parked tensors again after it (the device copy dropped)."""
    unet = it.Unet(**BASE, device=CPU)
    before = {n: (p, p.data_ptr()) for n, p in unet.named_parameters()}
    with on_device(unet, torch.device('meta')) as moved:
        assert moved is unet
        assert all(p.device.type == 'meta' for p in unet.parameters())
    for n, p in unet.named_parameters():
        assert p is before[n][0] and p.device.type == CPU and p.data_ptr() == before[n][1]
    with on_device(unet, torch.device(CPU)):   # already there: used as it is
        assert all(p.data_ptr() == before[n][1] for n, p in unet.named_parameters())


def test_edm_offload_inactive_unets_gives_the_plain_sample():
    kw = dict(image_sizes=SIZES[:2], text_embed_dim=16, num_sample_steps=(3, 2),
              cond_drop_prob=0.1, device=CPU)
    timagen = it.ElucidatedImagen([it.Unet(**BASE, device=CPU), it.Unet(**SR, device=CPU)], **kw)
    emb, mask = _text(74)
    sample = dict(text_embeds=t(emb), text_masks=t(mask), cond_scale=2.)
    plain = timagen.sample(**sample, generator=torch.Generator().manual_seed(4))
    offloaded = timagen.sample(**sample, offload_inactive_unets=True,
                               generator=torch.Generator().manual_seed(4))
    assert torch.equal(plain, offloaded)


@pytest.fixture(scope='module')
def null_first():
    kw = dict(image_sizes=(8, 16), text_embed_dim=16, timesteps=3, cond_drop_prob=0.1)
    jimagen = JImagen(unets=(JNullUnet(), JUnet(**BASE)), **kw)
    params = _params(jimagen, 1, 80)
    timagen = it.Imagen([it.NullUnet(device=CPU), it.Unet(**BASE, device=CPU)], **kw,
                        device=CPU)
    load_into(timagen.unets[1], params)
    return jimagen, params, timagen


def test_null_unet_first_stage_loss_matches_jax(null_first, monkeypatch):
    jimagen, params, timagen = null_first
    r = rng(81)
    emb, mask = _text(82)
    inputs = dict(x_start=r.rand(2, 16, 16, 3).astype(np.float32),
                  times=np.asarray([0.2, 0.7], np.float32), noise=randn(r, 2, 16, 16, 3),
                  text_embeds=emb, text_mask=mask,
                  lowres_cond_img=r.rand(2, 16, 16, 3).astype(np.float32),
                  lowres_aug_times=np.asarray([0.3, 0.05], np.float32))
    key = jax.random.PRNGKey(3)

    @jax.jit
    def jax_loss(p, inputs):
        x_start, times = inputs.pop('x_start'), inputs.pop('times')
        return jimagen.p_losses(jimagen.unets[1], jparams(p), x_start, times, key,
                                noise_scheduler=jimagen.noise_schedulers[1],
                                pred_objective=jimagen.pred_objectives[1], **inputs)

    ref = float(jax_loss(params, {k: jnp.asarray(v) for k, v in inputs.items()}))
    tin = {k: t(v) for k, v in inputs.items()}
    # JAX draws the low-res augmentation noise from the third key of its split
    tin['lowres_aug_noise'] = t(np.asarray(jax.random.normal(jax.random.split(key, 6)[2],
                                                             (2, 16, 16, 3))))
    x_start, times = tin.pop('x_start'), tin.pop('times')
    with torch.no_grad(), monkeypatch.context() as m:
        # JAX's key drops no text here; the port's text drop would come from
        # torch's unseeded global generator, so it is off for this comparison
        m.setattr(timagen, 'cond_drop_prob', 0.)
        mine = float(timagen.p_losses(timagen.unets[1], x_start, times,
                                      noise_scheduler=timagen.noise_schedulers[1],
                                      pred_objective=timagen.pred_objectives[1], **tin))
    with torch.no_grad():
        loss = timagen(t(inputs['x_start']), unet_number=2, text_embeds=t(emb),
                       text_masks=t(mask), generator=torch.Generator().manual_seed(1))
    assert ref > 1e-3
    assert abs(mine - ref) <= 1e-5 * abs(ref)
    assert loss.ndim == 0 and bool(torch.isfinite(loss))
    with pytest.raises(ValueError):   # the placeholder stage is not trained
        timagen(t(inputs['x_start']), unet_number=1, text_embeds=t(emb))


def test_sampling_from_unet_two_matches_jax(null_first):
    jimagen, params, timagen = null_first
    emb, mask = _text(83)
    r = rng(84)
    start = r.rand(2, 8, 8, 3).astype(np.float32)
    init, steps = randn(r, 2, 16, 16, 3), randn(r, 3, 2, 16, 16, 3)
    ref = jimagen.sample(({'params': {'dummy': jnp.zeros((1,))}}, jparams(params)), KEY,
                         text_embeds=jnp.asarray(emb), text_masks=jnp.asarray(mask),
                         cond_scale=2., start_at_unet_number=2,
                         start_image_or_video=jnp.asarray(start), use_tqdm=False,
                         noise_override=[None, (jnp.asarray(init), jnp.asarray(steps))])
    lowres = t(np.asarray(jax.random.normal(jax.random.fold_in(KEY, 1000 + 1),
                                            (2, 16, 16, 3))))
    out = timagen.sample(text_embeds=t(emb), text_masks=t(mask), cond_scale=2.,
                         start_at_unet_number=2, start_image_or_video=t(start),
                         noise_override=[None, (t(init), t(steps), lowres)])
    assert out.shape == (2, 16, 16, 3)
    assert max_abs(out, ref) <= 1e-2
    with pytest.raises(ValueError):   # stage 1 is the placeholder
        timagen.sample(text_embeds=t(emb))


def test_weights_bridge_is_strict_both_ways_on_sr1024():
    """A dim-8 `SRUnet1024` as a cascade casts it (low-res conditioned): the
    JAX leaves and the port's `state_dict` are the same set, shape for shape."""
    cfg = dict(dim=8, text_embed_dim=16, cond_dim=8, attn_dim_head=4, attn_heads=2,
               attn_pool_num_latents=2, max_text_len=8, learned_sinu_pos_emb_dim=4,
               lowres_cond=True)
    x, time = jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,))
    shapes = jax.eval_shape(lambda: JSRUnet1024(**cfg).init(
        jax.random.PRNGKey(0), x, time, text_embeds=jnp.zeros((1, 8, 16)),
        text_mask=jnp.ones((1, 8), bool), lowres_cond_img=x, lowres_noise_times=time))['params']
    sd = state_dict_from_jax(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                                    shapes))
    unet = it.SRUnet1024(**cfg, device=CPU)
    mine = unet.state_dict()
    assert len(sd) == len(jax.tree_util.tree_leaves(shapes))
    assert set(sd) == set(mine)
    for key, value in sd.items():
        assert value.shape == mine[key].shape, key
    unet.load_state_dict(sd, strict=True)
    assert 'init_resnet_block.block1.norm.gamma' in mine   # memory-efficient
    assert mine['init_conv.convs.2.weight'].shape == (2, 6, 15, 15)   # the 6-channel stem
    assert mine['final_conv.weight'].shape == (3, 8 + 3, 3, 3)   # the low-res image concatenated
