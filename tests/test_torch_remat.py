"""Remat in the port: the same loss and gradients with and without it.

`Unet(remat=True)`, `Unet(remat='save_convs')` and `Unet3D(remat=True)` at
dim 8 on bridged weights, in float64 on both sides (the attention softmax
too): loss and every gradient equal to the port without remat (rtol 1e-6)
and to `jax.grad` of the JAX unet with the same remat, within 1e-4 of the
largest gradient (in fp32 the packages' roundings in the Perceiver leave
them 2.7e-4 of it apart, as `test_torch_edm_training.py` notes). The JAX
unet cannot remat a linear-attention level (`nn.remat` traces its
`deterministic` flag), so the 2-D cases have none; the video one has
linear attention, linear cross-attention and the cross-embed downsample.
Then a linear-attention `Unet` in train mode, its dropout masks drawn from
the forward's generator: under either remat the same seed gives the
gradients of the run without remat, which a mask drawn again in the
recompute would break.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_bridge import jparams, load_into, max_abs, randn, random_params, rng, \
    softmax_in_input_dtype, t

from imagen_tpu.models.unet2d import Unet as JUnet
from imagen_tpu.models.unet3d import Unet3D as JUnet3D

import imagen_tpu_torch as it
from imagen_tpu_torch.utils.port_weights import state_dict_from_jax

TINY = dict(dim=8, dim_mults=(1, 2), num_resnet_blocks=1, text_embed_dim=16, cond_dim=8,
            attn_dim_head=4, attn_heads=2, attn_pool_num_latents=2, max_text_len=8)
CASES = {
    # transformer and full cross-attention at level 2 (the JAX remat test's pattern)
    'unet_true': (JUnet, it.Unet, dict(layer_attns=(False, True),
                                       layer_cross_attns=(False, True)), True),
    'unet_save_convs': (JUnet, it.Unet, dict(layer_attns=(False, True),
                                             layer_cross_attns=(False, True)), 'save_convs'),
    'unet3d_true': (JUnet3D, it.Unet3D, dict(layer_attns=False, layer_cross_attns=(False, True),
                                             use_linear_attn=True, use_linear_cross_attn=True,
                                             cross_embed_downsample=True), True),
}


def _inputs(video, seed=3, b=2, dtype=np.float32):
    r = rng(seed)
    x = randn(r, b, *((4,) if video else ()), 8, 8, 3)
    return tuple(a.astype(dtype) for a in (x, r.rand(b), randn(r, b, 8, 16)))


def _grads(unet, x, time, emb, cot, generator=None):
    unet.zero_grad(set_to_none=True)
    out = unet(t(x), t(time), text_embeds=t(emb), generator=generator)
    loss = (out * t(cot)).sum()
    loss.backward()
    return float(loss.detach()), {k: p.grad.clone() for k, p in unet.named_parameters()}


@pytest.mark.parametrize('name', list(CASES))
def test_remat_matches_no_remat_and_jax(name, monkeypatch):
    jklass, tklass, extra, remat = CASES[name]
    cfg = {**TINY, **extra}
    video = jklass is JUnet3D
    softmax_in_input_dtype(monkeypatch)
    with jax.enable_x64(True):
        x, time, emb = _inputs(video, dtype=np.float64)
        cot = randn(rng(4), *x.shape).astype(np.float64)
        junet = jklass(**cfg, remat=remat, dtype=jnp.float64)
        params = jax.tree_util.tree_map(lambda a: a.astype(np.float64), random_params(
            junet, jnp.asarray(x), jnp.asarray(time), text_embeds=jnp.asarray(emb), seed=5))

        def jloss(p):
            out = junet.apply(p, jnp.asarray(x), jnp.asarray(time),
                              text_embeds=jnp.asarray(emb))
            return jnp.sum(out * cot)

        jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams(params))
        expected = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jg['params']),
                                       video=video)

    f64 = dict(dtype=torch.float64, device='cpu')
    plain = load_into(tklass(**cfg, **f64), params).double()
    rematted = load_into(tklass(**cfg, remat=remat, **f64), params).double()
    loss0, grads0 = _grads(plain, x, time, emb, cot)
    loss1, grads1 = _grads(rematted, x, time, emb, cot)
    assert abs(loss1 - loss0) <= 1e-6 * abs(loss0)
    assert grads1.keys() == grads0.keys() == expected.keys()
    for k in grads0:
        torch.testing.assert_close(grads1[k], grads0[k], rtol=1e-6, atol=0.)
    assert abs(loss1 - float(jl)) <= 1e-4 * max(1., abs(float(jl)))
    largest = max(float(v.abs().max()) for v in expected.values())
    assert max(max_abs(grads1[k], v) for k, v in expected.items()) <= 1e-4 * largest


@pytest.mark.parametrize('remat', [True, 'save_convs'])
def test_train_mode_dropout_under_remat(remat):
    """Linear attention and linear cross-attention at level 1, in train mode
    (dropout 0.05 on q, k and v); cond_drop_prob 0.5 draws from the same
    generator first."""
    cfg = dict(TINY, layer_attns=(False, True), layer_cross_attns=(False, True),
               use_linear_attn=(True, False), use_linear_cross_attn=(True, False))
    x, time, emb = _inputs(video=False)
    cot = randn(rng(4), *x.shape)
    torch.manual_seed(0)
    plain = it.Unet(**cfg, device='cpu')
    rematted = it.Unet(**cfg, remat=remat, device='cpu')
    rematted.load_state_dict(plain.state_dict())
    torch.nn.init.normal_(plain.final_conv.weight)
    rematted.final_conv.weight.data.copy_(plain.final_conv.weight.data)

    def run(unet, seed):
        unet.train().zero_grad(set_to_none=True)
        out = unet(t(x), t(time), text_embeds=t(emb), cond_drop_prob=0.5,
                   generator=torch.Generator().manual_seed(seed))
        (out * t(cot)).sum().backward()
        return out.detach(), {k: p.grad.clone() for k, p in unet.named_parameters()}

    out0, grads0 = run(plain, 11)
    out1, grads1 = run(rematted, 11)
    assert torch.equal(out1, out0)
    for k in grads0:
        torch.testing.assert_close(grads1[k], grads0[k], rtol=1e-6, atol=0.)
    # the masks matter: another seed gives other gradients
    _, grads2 = run(rematted, 12)
    attn_q = 'downs.0.3.layers.0.0.to_q.1.weight'
    assert max_abs(grads2[attn_q], grads0[attn_q]) > 1e-4


@pytest.mark.parametrize('remat', [False, True, 'save_convs'])
def test_what_the_backward_runs_again(remat):
    """The 3x3 convs and the Block prologues that run in the backward pass:
    True runs every conv again; 'save_convs' runs none, as JAX's
    save_only_these_names('conv_out', ...) keeps their outputs, and each
    prologue once; False runs nothing again."""
    from imagen_tpu_torch.models.blocks import Block, SameConv3x3
    cfg = dict(TINY, layer_attns=(False, True), layer_cross_attns=(False, True))
    x, time, emb = _inputs(video=False)
    unet = it.Unet(**cfg, remat=remat, device='cpu')
    convs = [m for m in unet.modules() if isinstance(m, SameConv3x3)]
    blocks = [m for m in unet.modules() if isinstance(m, Block)]
    runs = {'conv': 0, 'prologue': 0}

    def count(key):
        def hook(*_):
            runs[key] += 1
        return hook

    for m in convs:
        m.register_forward_hook(count('conv'))
    for m in blocks:
        m.prologue = _counted(m.prologue, runs)
    out = unet(t(x), t(time), text_embeds=t(emb))
    forward = dict(runs)
    out.sum().backward()
    again = {k: runs[k] - forward[k] for k in runs}
    assert forward['conv'] >= len(blocks) > 0
    expected = {False: {'conv': 0, 'prologue': 0},
                True: forward,
                'save_convs': {'conv': 0, 'prologue': len(blocks)}}[remat]
    assert again == expected


def _counted(fn, runs):
    def wrapped(*args, **kwargs):
        runs['prologue'] += 1
        return fn(*args, **kwargs)
    return wrapped


def test_save_convs_frees_what_the_backward_rebuilds():
    """What a `'save_convs'` backward rebuilds lives only until that backward
    ends: a second step leaves as many tensors alive as the first."""
    import gc
    cfg = dict(TINY, layer_attns=(False, True), layer_cross_attns=(False, True))
    x, time, emb = _inputs(video=False)
    unet = it.Unet(**cfg, remat='save_convs', device='cpu')

    def alive_after_step():
        unet(t(x), t(time), text_embeds=t(emb)).sum().backward()
        gc.collect()
        return sum(issubclass(type(o), torch.Tensor) for o in gc.get_objects())

    first = alive_after_step()
    assert alive_after_step() == first
