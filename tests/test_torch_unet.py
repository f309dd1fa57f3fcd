"""The port's Unet against the JAX Unet on bridged weights, fp32, to 1e-4.

Base (text-conditioned, attention at the second level) and memory-efficient
SR (low-res conditioned) dim-8 configs, each as the plain forward
(cond_scale 1) and as the classifier-free-guidance doubled-batch forward
(cond_scale 3). Every weight is drawn, so no zero init (e.g. the final conv)
hides part of the network.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_bridge import BASE_CFG, SR_CFG, jparams, load_into, max_abs, randn, \
    random_params, rng, t

from imagen_tpu.models.unet2d import Unet as JUnet

import imagen_tpu_torch as it
from imagen_tpu_torch.diffusion.imagen import unet_forward_with_cond_scale

TOL = 1e-4


def _inputs(cfg, seed, b=2, size=16):
    r = rng(seed)
    x = randn(r, b, size, size, 3)
    time = r.rand(b).astype(np.float32)
    mask = np.ones((b, 8), bool)
    mask[1, 5:] = False
    kw = dict(text_embeds=randn(r, b, 8, 16) * mask[..., None], text_mask=mask)
    if cfg.get('lowres_cond'):
        kw.update(lowres_cond_img=randn(r, b, size, size, 3),
                  lowres_noise_times=r.rand(b).astype(np.float32))
    return x, time, kw


@pytest.mark.parametrize('cond_scale', [1., 3.])
@pytest.mark.parametrize('name', ['base', 'sr'])
def test_unet_forward_matches_jax(name, cond_scale):
    """cond_scale 1 is the plain forward. At cond_scale 3 the doubled-batch
    forward (conditional half, then the null half via force_text_drop_mask)
    is held to 1e-4; the guided output null + 3 (cond - null) carries that
    error times at most 2 * 3 - 1 = 5."""
    cfg = BASE_CFG if name == 'base' else SR_CFG
    x, time, kw = _inputs(cfg, seed=len(name))
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    junet = JUnet(**cfg)
    params = random_params(junet, jnp.asarray(x[:1]), jnp.asarray(time[:1]),
                           **{k: v[:1] for k, v in jkw.items()}, seed=11)
    unet = load_into(it.Unet(**cfg, device='cpu'), params)
    tkw = {k: t(v) for k, v in kw.items()}

    if cond_scale != 1.:
        b = x.shape[0]
        drop = np.repeat([False, True], b)

        def double(a):
            return np.concatenate((a, a))

        ref = jax.jit(junet.apply)(
            jparams(params), jnp.asarray(double(x)), jnp.asarray(double(time)),
            force_text_drop_mask=jnp.asarray(drop), **{k: jnp.asarray(double(v))
                                                       for k, v in kw.items()})
        with torch.no_grad():
            both = unet(t(double(x)), t(double(time)), force_text_drop_mask=t(drop),
                        **{k: t(double(v)) for k, v in kw.items()})
        assert max_abs(both, ref) <= TOL
        assert max_abs(both[:b], both[b:]) > 0.01  # the null half is really dropped
        # the guidance of imagen_tpu's unet_forward_with_cond_scale on that forward
        ref = ref[b:] + (ref[:b] - ref[b:]) * cond_scale
    else:
        ref = jax.jit(junet.apply)(jparams(params), jnp.asarray(x), jnp.asarray(time), **jkw)
    with torch.no_grad():
        out = unet_forward_with_cond_scale(unet, t(x), t(time), cond_scale=cond_scale, **tkw)
    assert out.shape == x.shape
    assert float(np.abs(np.asarray(ref)).max()) > 0.1  # the network is not hidden
    assert max_abs(out, ref) <= TOL * (2 * cond_scale - 1)
