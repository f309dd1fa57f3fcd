"""Gradients of the port against the JAX package, fp32, on the CPU.

Same seeded numpy inputs and weights (bridged by `state_dict_from_jax`) on
both sides:
- the conv and feedforward autograd Functions against `jax.vjp` of the XLA
  references, 1e-5 of max(1, the output's max |value|);
- every Unet parameter gradient against `jax.grad`, 1e-3 of that tensor's
  max |gradient| (`GRAD_TOL` says why).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_bridge import BASE_CFG, SR_CFG, jparams, load_into, max_abs, randn, \
    random_params, rng, t

import imagen_tpu.ops.conv2d as jc2d
import imagen_tpu.ops.fused_norm as jfn
from imagen_tpu.models.unet2d import Unet as JUnet

import imagen_tpu_torch as it
from imagen_tpu_torch.ops import conv2d as c2d
from imagen_tpu_torch.ops import fused_norm as fn
from imagen_tpu_torch.utils.port_weights import state_dict_from_jax

CPU = 'cpu'


def rel_err(a, ref):
    return max_abs(a, ref) / max(1., float(np.abs(np.asarray(ref)).max()))


def _vjp_torch(fn, inputs, cot):
    leaves = [t(x).requires_grad_() for x in inputs]
    out = fn(*leaves)
    (out * t(cot)).sum().backward()
    return out, [x.grad for x in leaves]


# --- the kernel wrappers' autograd Functions ------------------------------------------------

def test_conv2d_function_gradients_match_jax():
    r = rng(0)
    x, w, b = randn(r, 2, 8, 64, 32), randn(r, 3, 3, 32, 20, scale=0.1), randn(r, 20)
    cot = randn(r, 2, 8, 64, 20)
    ref_out, vjp = jax.vjp(jc2d._xla_reference, *map(jnp.asarray, (x, w, b)))
    out, grads = _vjp_torch(c2d.conv2d_same, (x, w, b), cot)
    assert rel_err(out, ref_out) <= 1e-5
    for name, a, ref in zip(('dx', 'dw', 'db'), grads, vjp(jnp.asarray(cot))):
        assert rel_err(a, ref) <= 1e-5, name


def test_fused_feedforward_function_gradients_match_jax():
    r = rng(1)
    k, hid = 64, 128
    x, g0, g1 = randn(r, 2, 24, k), 1. + randn(r, k, scale=0.1), 1. + randn(r, hid, scale=0.1)
    w0, w1 = randn(r, k, hid, scale=k ** -0.5), randn(r, hid, k, scale=hid ** -0.5)
    cot = randn(r, 2, 24, k)
    ref_out, vjp = jax.vjp(lambda *a: jfn._ff_xla(*a, 1e-5), *map(jnp.asarray, (x, g0, w0, g1, w1)))
    # torch Linear layout: w0 (hid, k), w1 (k, hid)
    out, grads = _vjp_torch(lambda x, g0, w0, g1, w1: fn.fused_feedforward(x, g0, w0, g1, w1, 1e-5),
                            (x, g0, w0.T, g1, w1.T), cot)
    assert rel_err(out, ref_out) <= 1e-5
    ref = list(vjp(jnp.asarray(cot)))
    ref[2], ref[4] = ref[2].T, ref[4].T
    for name, a, b in zip(('dx', 'dg0', 'dw0', 'dg1', 'dw1'), grads, ref):
        assert rel_err(a, b) <= 1e-5, name


# fp32 rounding, amplified through a random net, moves a tensor's gradient
# by up to about 2e-4 of its largest entry: the JAX package's own jit and
# eager gradients of this test's base Unet differ by up to 1.7e-4 there. The
# key biases of global-context attention have a gradient of exactly zero
# (the softmax over positions ignores a shift), so theirs is rounding noise:
# the scale of every tensor is floored at 1e-5 of the net's largest gradient.
GRAD_TOL = 1e-3


@pytest.mark.parametrize('name', ['base', 'sr'])
def test_unet_parameter_gradients_match_jax(name):
    cfg = BASE_CFG if name == 'base' else SR_CFG
    r = rng(6)
    b = 2
    x, time = randn(r, b, 16, 16, 3), r.rand(b).astype(np.float32)
    mask = np.ones((b, 8), bool)
    mask[0, 5:] = False
    kw = dict(text_embeds=randn(r, b, 8, 16) * mask[..., None], text_mask=mask)
    if cfg.get('lowres_cond'):
        kw.update(lowres_cond_img=randn(r, b, 16, 16, 3),
                  lowres_noise_times=r.rand(b).astype(np.float32))
    cot = randn(r, b, 16, 16, 3)
    junet = JUnet(**cfg)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    params = random_params(junet, jnp.asarray(x[:1]), jnp.asarray(time[:1]),
                           **{k: v[:1] for k, v in jkw.items()}, seed=12)

    def loss(p):
        out = junet.apply({'params': p}, jnp.asarray(x), jnp.asarray(time), **jkw)
        return jnp.sum(out * cot)

    ref = state_dict_from_jax(jax.jit(jax.grad(loss))(jparams(params)['params']))
    unet = load_into(it.Unet(**cfg, device=CPU), params)
    (unet(t(x), t(time), **{k: t(v) for k, v in kw.items()}) * t(cot)).sum().backward()
    grads = {k: p.grad for k, p in unet.named_parameters()}
    assert set(grads) == set(ref)
    largest = max(float(g.abs().max()) for g in ref.values())
    for k, g in grads.items():
        assert g is not None, k
        scale = max(float(ref[k].abs().max()), 1e-5 * largest)
        assert max_abs(g, ref[k]) <= GRAD_TOL * scale, k
