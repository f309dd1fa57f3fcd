"""The port's U-Net options against the JAX package: linear attention,
linear cross-attention, cross-embed downsample, remat in configs and files.

`Unet` at the configs of `tests/test_unet2d.py` that use them (linear
attention in a memory-efficient low-res-conditioned unet; cross-embed
downsample with combined upsample fmaps and the init-conv residual), the
`SR_CFG` of `tests/test_reference_parity.py`, and that SR config with linear
cross-attention and the cross-embed downsample; `Unet3D` with linear
attention, linear cross-attention and the cross-embed downsample. Seeded
weights go through `state_dict_from_jax` strictly both ways (every JAX leaf
used once, every port parameter given); each fp32 forward to 1e-4. Then a
config carrying the options builds in both packages with the same
`model_dump()`, `unet_from_config` builds with remat, and a JAX trainer's
bundle of a linear-attention unet loads into the port's trainer
(`only_model=True`) and gives the JAX forward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_bridge import jparams, load_into, max_abs, randn, random_params, rng, t

from imagen_tpu.configs import ImagenConfig as JImagenConfig
from imagen_tpu.configs import UnetConfig as JUnetConfig
from imagen_tpu.models.unet2d import Unet as JUnet
from imagen_tpu.models.unet3d import Unet3D as JUnet3D
from imagen_tpu.trainer import ImagenTrainer as JTrainer

import imagen_tpu_torch as it
from imagen_tpu_torch import configs
from imagen_tpu_torch.utils import persist
from imagen_tpu_torch.utils.port_weights import state_dict_from_jax

CPU = 'cpu'
TINY = dict(dim=8, dim_mults=(1, 1, 1, 1), text_embed_dim=16, cond_dim=8, attn_dim_head=4,
            attn_heads=2, attn_pool_num_latents=2, max_text_len=8)
SR = dict(dim=8, dim_mults=(1, 2), num_resnet_blocks=1, layer_attns=False,
          layer_cross_attns=(False, True), use_linear_attn=(True, False), attn_heads=2,
          attn_dim_head=4, text_embed_dim=16, cond_dim=8, max_text_len=8, attn_pool_text=True,
          attn_pool_num_latents=2, learned_sinu_pos_emb_dim=4, memory_efficient=True,
          pixel_shuffle_upsample=False, lowres_cond=True)
CASES = {
    # tests/test_unet2d.py:42-55
    'linear_memory_efficient': (JUnet, dict(
        TINY, lowres_cond=True, memory_efficient=True, layer_attns=False,
        layer_cross_attns=(False, False, False, True),
        use_linear_attn=(True, False, False, False))),
    # tests/test_unet2d.py:90-100
    'cross_embed_downsample': (JUnet, dict(
        TINY, combine_upsample_fmaps=True, init_conv_to_final_conv_residual=True,
        pixel_shuffle_upsample=False, cross_embed_downsample=True, layer_attns=False,
        layer_cross_attns=False, attn_pool_text=False, scale_skip_connection=False,
        final_resnet_block=False, init_cross_embed=False)),
    # tests/test_reference_parity.py:38-46
    'sr_cfg': (JUnet, SR),
    # the chip path's SR pattern: linear self and cross-attention, the cross-embed downsample
    'sr_linear_cross': (JUnet, dict(SR, layer_cross_attns=(False, True),
                                    use_linear_cross_attn=(True, False),
                                    cross_embed_downsample=True)),
    'unet3d': (JUnet3D, dict(dim=8, dim_mults=(1, 2), text_embed_dim=16, cond_dim=8,
                             attn_dim_head=4, attn_heads=2, attn_pool_num_latents=2,
                             max_text_len=8, layer_attns=False, layer_cross_attns=(False, True),
                             use_linear_attn=True, use_linear_cross_attn=True,
                             cross_embed_downsample=True)),
}


def _inputs(cfg, video, seed, b=2, size=16):
    r = rng(seed)
    lead = (b, 4) if video else (b,)
    x = randn(r, *lead, size, size, 3)
    mask = np.ones((b, 8), bool)
    mask[1, 5:] = False
    kw = dict(text_embeds=randn(r, b, 8, 16) * mask[..., None], text_mask=mask)
    if cfg.get('lowres_cond'):
        kw.update(lowres_cond_img=randn(r, *lead, size, size, 3),
                  lowres_noise_times=r.rand(b).astype(np.float32))
    return x, r.rand(b).astype(np.float32), kw


@pytest.mark.parametrize('name', list(CASES))
def test_unet_forward_matches_jax(name):
    jklass, cfg = CASES[name]
    video = jklass is JUnet3D
    x, time, kw = _inputs(cfg, video, seed=len(name), size=8 if video else 16)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    junet = jklass(**cfg)
    params = random_params(junet, jnp.asarray(x), jnp.asarray(time), **jkw, seed=21)
    sd = state_dict_from_jax(params)
    n_leaves = len(jax.tree_util.tree_leaves(params))
    unet = (it.Unet3D if video else it.Unet)(**cfg, device=CPU)
    assert len(sd) == n_leaves and set(sd) == set(unet.state_dict())
    load_into(unet, params)
    ref = jax.jit(junet.apply)(jparams(params), jnp.asarray(x), jnp.asarray(time), **jkw)
    with torch.no_grad():
        out = unet(t(x), t(time), **{k: t(v) for k, v in kw.items()})
    assert out.shape == x.shape
    assert float(np.abs(np.asarray(ref)).max()) > 0.1
    assert max_abs(out, ref) <= 1e-4


OPTIONS = dict(dim=8, dim_mults=[1, 2], text_embed_dim=16, cond_dim=8, attn_dim_head=4,
               attn_heads=2, attn_pool_num_latents=2, max_text_len=8, layer_attns=False,
               layer_cross_attns=[False, True], use_linear_attn=[True, False],
               use_linear_cross_attn=[True, False], cross_embed_downsample=True,
               remat='save_convs')
IMAGEN = dict(unets=[OPTIONS], image_sizes=[16], timesteps=4, text_embed_dim=16,
              cond_drop_prob=0.1, resize_mode='linear')
# the JAX unet cannot remat a linear-attention level (`nn.remat` traces its
# `deterministic` flag), so its models are built without remat: the same params
JAX_IMAGEN = dict(IMAGEN, unets=[dict(OPTIONS, remat=False)])


def test_configs_and_files_carry_the_options(tmp_path):
    """The same `model_dump()` in both packages; `.create()` builds the
    options (remat included) and bridges strictly; a persisted unet with
    remat comes back with it."""
    assert configs.UnetConfig(**OPTIONS).model_dump() == JUnetConfig(**OPTIONS).model_dump()
    assert configs.ImagenConfig(**IMAGEN).model_dump() == JImagenConfig(**IMAGEN).model_dump()
    imagen = configs.ImagenConfig(**IMAGEN).create(device=CPU)
    jimagen = JImagenConfig(**JAX_IMAGEN).create()
    unet = imagen.unets[0]
    assert imagen.resize_mode == 'linear' and unet._config['remat'] == 'save_convs'
    assert unet.downs[0][3].remat == 'save_convs' and unet.downs[0][1].cross_attn.linear
    assert isinstance(unet.downs[0][4], it.models.blocks.CrossEmbedLayer)
    x, time = jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,))
    params = random_params(jimagen.unets[0], x, time, text_embeds=jnp.zeros((1, 8, 16)), seed=3)
    load_into(unet, params)

    persist.persist_unet_to_file(unet, tmp_path / 'unet.ckpt')
    again = persist.hydrate_unet_from_file(tmp_path / 'unet.ckpt', device=CPU)
    assert again._config == unet._config and again.mid_block1.remat == 'save_convs'
    built = persist.unet_from_config(it.Unet, dict(OPTIONS, remat=True), device=CPU)
    assert built.mid_block1.remat is True


def test_jax_bundle_of_a_linear_attention_unet_loads_into_the_port(tmp_path):
    jimagen = JImagenConfig(**JAX_IMAGEN).create()
    trainer = JTrainer(imagen=jimagen, verbose=False)
    x, time = jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,))
    online, ema = (random_params(jimagen.unets[0], x, time, text_embeds=jnp.zeros((1, 8, 16)),
                                 seed=s) for s in (30, 31))
    trainer.params, trainer.ema_params = [jparams(online)], [jparams(ema)]
    trainer.opt_states = [opt.init(p) for opt, p in zip(trainer._optimizers, trainer.params)]
    path = str(tmp_path / 'jax.ckpt')
    trainer.save(path)

    ported = it.ImagenTrainerConfig(imagen=IMAGEN, verbose=False).create(device=CPU)
    ported.load(path, only_model=True)
    unet = ported.unets[0].eval()
    r = rng(32)
    xs, times, emb = randn(r, 2, 16, 16, 3), r.rand(2).astype(np.float32), randn(r, 2, 8, 16)
    ref = jax.jit(jimagen.unets[0].apply)(jparams(online), jnp.asarray(xs), jnp.asarray(times),
                                          text_embeds=jnp.asarray(emb))
    with torch.no_grad():
        out = unet(t(xs), t(times), text_embeds=t(emb))
    assert float(np.abs(np.asarray(ref)).max()) > 0.1
    assert max_abs(out, ref) <= 1e-4
