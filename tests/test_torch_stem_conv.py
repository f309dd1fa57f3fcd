"""The port's CrossEmbed stem (kernel 14) and channel-first tiny-cout conv
(kernel 7) against the JAX package in fp32 on the CPU.

On the CPU each wrapper runs its plain version. The plain versions are held
to 1e-5 against the XLA references (`stem_conv._xla_reference`,
`conv2d._xla_reference_cf`) and against the Pallas bodies in interpret mode
(`stem_conv._forward`, `conv2d._forward_cf`); the autograd Functions'
gradients to `jax.grad` of the references (1e-5 of each gradient's largest
value); the gates to the JAX shape conditions. `CrossEmbedLayer` and a dim-8
`Unet`, whose stems take the kernel's route where the gate admits them, are
held to the JAX modules (1e-4; the Unet in float64 on both sides) and to
the port's plain route with the gate closed (1e-5), with a count showing the stem went the kernel's way. The CUDA
kernels themselves are held to the plain versions in `tests/test_torch_cuda.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_bridge import BASE_CFG, load_block, load_into, max_abs, randn, \
    random_params, rng, softmax_in_input_dtype, t

import imagen_tpu.ops.conv2d as jc2d
import imagen_tpu.ops.stem_conv as jstem
from imagen_tpu.models import blocks as jb
from imagen_tpu.models.unet2d import Unet as JUnet
from imagen_tpu_torch.models import blocks
from imagen_tpu_torch.ops import conv2d as c2d
from imagen_tpu_torch.ops import stem_conv as stem

import imagen_tpu_torch as it

TOL = 1e-5
KERNELS = (3, 7, 15)


def _stem_inputs(seed, c, dims=(16, 8, 8), b=2, hw=32):
    r = rng(seed)
    ws = [randn(r, k, k, c, d, scale=(k * k * c) ** -0.5) for k, d in zip(KERNELS, dims)]
    return randn(r, b, hw, hw, c), ws, randn(r, sum(dims), scale=0.1)


@pytest.mark.parametrize('c', [3, 6])
def test_stem_plain_version_matches_xla_and_pallas(c):
    x, ws, bias = _stem_inputs(0, c)
    jx, jws, jbias = jnp.asarray(x), [jnp.asarray(w) for w in ws], jnp.asarray(bias)
    xla = jax.jit(jstem._xla_reference)(jx, jws, jbias)
    pallas = jstem._forward(jx, jws, jbias, interpret=True)
    mine = stem.cross_embed_stem(t(x), [t(w) for w in ws], t(bias))
    assert mine.shape == (2, 32, 32, 32)
    assert max_abs(mine, xla) <= TOL
    assert max_abs(mine, pallas) <= TOL


def _cf_inputs(seed, cin, h=16, w=128, cout=3, k=3):
    r = rng(seed)
    return (randn(r, 1, h, w, cin), randn(r, k, k, cin, cout, scale=(k * k * cin) ** -0.5),
            randn(r, cout, scale=0.1))


@pytest.mark.parametrize('cin', [128, 131])
def test_cf_plain_version_matches_xla_and_pallas(cin):
    """At 16 x 128, past no VMEM limit of the Pallas body; cin 131, the SR
    unets' final conv, is held to the XLA reference only (the Pallas body's
    gate takes cin % 128 == 0)."""
    x, w, bias = _cf_inputs(1, cin)
    jx, jw, jbias = map(jnp.asarray, (x, w, bias))
    mine = c2d.conv2d_same_cf(t(x), t(w), t(bias))
    assert mine.shape == (1, 3, 16, 128)
    assert max_abs(mine, jax.jit(jc2d._xla_reference_cf)(jx, jw, jbias)) <= TOL
    if cin % 128 == 0:
        assert max_abs(mine, jc2d._forward_cf(jx, jw, jbias, interpret=True)) <= TOL
    no_bias = c2d.conv2d_same_cf(t(x), t(w), None)
    assert max_abs(no_bias + t(bias)[:, None, None], mine) <= TOL


def _grads_match(jax_fn, torch_fn, arrays):
    """jax.grad of sum(f * cot) against the port's Function gradients, each
    to TOL of its largest value."""
    cot = randn(rng(3), *jax.eval_shape(jax_fn, *map(jnp.asarray, arrays)).shape)

    def jloss(*a):
        return jnp.sum(jax_fn(*a) * jnp.asarray(cot))

    ref = jax.jit(jax.grad(jloss, argnums=tuple(range(len(arrays)))))(*map(jnp.asarray, arrays))
    leaves = [t(a).requires_grad_() for a in arrays]
    (torch_fn(*leaves) * t(cot)).sum().backward()
    for i, (leaf, grad) in enumerate(zip(leaves, ref)):
        grad = np.asarray(grad)
        assert max_abs(leaf.grad, grad) <= TOL * max(1., float(np.abs(grad).max())), i


def test_stem_function_gradients_match_jax():
    x, ws, bias = _stem_inputs(4, 6, hw=16)
    _grads_match(lambda x, b, *ws: jstem._xla_reference(x, list(ws), b),
                 lambda x, b, *ws: stem.cross_embed_stem(x, list(ws), b), (x, bias, *ws))


def test_cf_function_gradients_match_jax():
    _grads_match(jc2d._xla_reference_cf, c2d.conv2d_same_cf, _cf_inputs(5, 131, h=8, w=16))


def test_gates_match_the_jax_shape_conditions(monkeypatch):
    monkeypatch.setattr(jc2d, '_INTERPRET', True)
    stem_cases = [((2, 1024, 1024, 6), KERNELS), ((8, 256, 256, 6), KERNELS),
                  ((8, 64, 64, 3), KERNELS), ((2, 32, 32, 8), (3, 7)),
                  ((2, 32, 32, 9), KERNELS), ((2, 30, 32, 6), KERNELS),
                  ((2, 32, 30, 6), KERNELS), ((2, 32, 32, 6), (2, 4)),
                  ((2, 32, 6), KERNELS), ((2, 36, 36, 3), (1, 5, 9, 13))]
    for shape, ks in stem_cases:
        expected = jstem.stem_available(shape, ks, interpret=True)
        assert stem.stem_available(shape, ks, torch.float32, 'cpu') == expected, (shape, ks)
        assert stem.stem_available(shape, ks, torch.bfloat16, 'cuda') == expected, (shape, ks)
        assert not stem.stem_available(shape, ks, torch.float32, 'cuda')
    # the kernel's own limits, which the JAX gate does not have
    assert not stem.stem_available((2, 32, 32, 6), (17,), torch.bfloat16, 'cuda')
    assert not stem.stem_available((2, 32, 32, 6), (1, 3, 5, 7, 9), torch.bfloat16, 'cuda')

    cf_cases = [((2, 1024, 1024, 128), (3, 3, 128, 3)), ((2, 1024, 1024, 131), (3, 3, 131, 3)),
                ((1, 256, 256, 256), (3, 3, 256, 8)), ((1, 256, 256, 128), (3, 3, 128, 9)),
                ((1, 128, 256, 128), (3, 3, 128, 3)), ((1, 256, 200, 128), (3, 3, 128, 3)),
                ((1, 252, 256, 128), (3, 3, 128, 3)), ((1, 256, 256, 128), (5, 5, 128, 3)),
                ((1, 256, 256, 128), (3, 5, 128, 3)), ((1, 256, 256, 128), (4, 4, 128, 3)),
                ((1, 256, 256, 128), (3, 3, 64, 3))]
    for xs, ws in cf_cases:
        expected = jc2d.conv2d_same_cf_available(xs, ws, jnp.float32)
        assert c2d.conv2d_same_cf_available(xs, ws, torch.float32, 'cpu') == expected, (xs, ws)
        assert c2d.conv2d_same_cf_available(xs, ws, torch.bfloat16, 'cuda') == expected
        assert not c2d.conv2d_same_cf_available(xs, ws, torch.float32, 'cuda')


def _count_stem_calls(monkeypatch):
    calls = []
    kernel_route = blocks.cross_embed_stem

    def spy(x, ws, bias, packed=None):
        calls.append(tuple(x.shape))
        return kernel_route(x, ws, bias, packed=packed)

    monkeypatch.setattr(blocks, 'cross_embed_stem', spy)
    return calls


def _plain_route(monkeypatch, fn):
    """fn() with the stem gate closed: the layer's three F.conv2d and the cat."""
    with monkeypatch.context() as m:
        m.setattr(blocks, 'stem_available', lambda *a, **k: False)
        return fn()


@pytest.mark.parametrize('c', [3, 6])
def test_cross_embed_layer_fused_stem_matches_jax(c, monkeypatch):
    calls = _count_stem_calls(monkeypatch)
    x = randn(rng(6), 2, 16, 16, c)
    jlayer = jb.CrossEmbedLayer(kernel_sizes=KERNELS, dim_out=32, stride=1)
    params = random_params(jlayer, jnp.asarray(x), seed=7)
    ref = jax.jit(jlayer.apply)({'params': jax.tree_util.tree_map(jnp.asarray, params)},
                                jnp.asarray(x))
    layer = load_block(blocks.CrossEmbedLayer(c, KERNELS, dim_out=32, stride=1), params,
                       'init_conv', 'init_conv.')
    with torch.no_grad():
        out = layer(t(x))
        plain = _plain_route(monkeypatch, lambda: layer(t(x)))
    assert calls == [(2, 16, 16, c)]
    assert max_abs(out, ref) <= 1e-4
    assert max_abs(out, plain) <= TOL


def test_unet_with_fused_stem_matches_jax(monkeypatch):
    """A dim-8 Unet whose stem takes the kernel's route: in fp32 against the
    plain route (1e-5), and in float64 on both sides against the JAX Unet
    (1e-4; they agree to 1e-13, where an fp32 run ends 1.5e-4 apart at
    outputs up to 6, through the whole net's rounding)."""
    calls = _count_stem_calls(monkeypatch)
    softmax_in_input_dtype(monkeypatch)
    r = rng(8)
    x, time = randn(r, 2, 16, 16, 3), r.rand(2).astype(np.float32)
    emb, mask = randn(r, 2, 8, 16), np.ones((2, 8), bool)
    with jax.enable_x64(True):
        junet = JUnet(**BASE_CFG, dtype=jnp.float64)
        f64 = lambda a: jnp.asarray(np.asarray(a, np.float64))  # noqa: E731
        kw = dict(text_embeds=f64(emb), text_mask=jnp.asarray(mask))
        params = random_params(junet, f64(x), f64(time), **kw, seed=9)
        ref = np.asarray(jax.jit(junet.apply)({'params': jax.tree_util.tree_map(f64, params)},
                                              f64(x), f64(time), **kw))
    assert ref.dtype == np.float64
    unet = load_into(it.Unet(**BASE_CFG, device='cpu'), params)
    unet64 = load_into(it.Unet(**BASE_CFG, dtype=torch.float64, device='cpu'), params).double()
    d = lambda a: torch.from_numpy(np.asarray(a, np.float64))  # noqa: E731
    with torch.no_grad():
        out = unet(t(x), t(time), text_embeds=t(emb), text_mask=t(mask))
        plain_out = _plain_route(
            monkeypatch, lambda: unet(t(x), t(time), text_embeds=t(emb), text_mask=t(mask)))
        out64 = unet64(d(x), d(time), text_embeds=d(emb), text_mask=t(mask))
    assert calls == [(2, 16, 16, 3), (2, 16, 16, 3)]
    assert out64.dtype == torch.float64
    assert max_abs(out64, ref) <= 1e-4
    assert max_abs(out, plain_out) <= TOL


def test_cross_embed_layer_repacks_after_its_parameters_change():
    """The layer keeps the kernel's weights between calls without a gradient;
    an in-place update, new data or a move drops them. In bf16 the kept weights are
    copies, so a stale one would change the output."""
    x = t(randn(rng(12), 1, 8, 8, 3)).to(torch.bfloat16)
    layer = blocks.CrossEmbedLayer(3, KERNELS, dim_out=16, stride=1, dtype=torch.bfloat16)
    with torch.no_grad():
        before = layer(x)
        assert layer(x) is not before and torch.equal(layer(x), before)
        layer.convs[2].weight.mul_(2.)
        layer.convs[0].bias.add_(1.)
        after = layer(x)
        fresh = blocks.CrossEmbedLayer(3, KERNELS, dim_out=16, stride=1, dtype=torch.bfloat16)
        fresh.load_state_dict(layer.state_dict())
        assert not torch.equal(after, before)
        assert torch.equal(after, fresh(x))
        for conv in layer.convs:   # new data, as a parked unet gets back its host copy
            conv.weight.data = conv.weight.data.clone().neg_()
        fresh.load_state_dict(layer.state_dict())
        swapped = layer(x)
        assert not torch.equal(swapped, after)
        assert torch.equal(swapped, fresh(x))
        layer.to(torch.float64)
        assert layer._kept is None


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x, ws, bias = _stem_inputs(10, 3, hw=8)
    with pytest.raises(ValueError):   # a meta tensor is neither on the CPU nor on a card
        stem.cross_embed_stem(t(x).to('meta'), [t(w).to('meta') for w in ws],
                              t(bias).to('meta'))
    xc, w, b = _cf_inputs(11, 16, h=8, w=8)
    with pytest.raises(ValueError):
        c2d.conv2d_same_cf(t(xc).to('meta'), t(w).to('meta'), None)
