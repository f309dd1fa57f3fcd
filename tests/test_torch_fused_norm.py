"""The port's ChanRMSNorm·FiLM·SiLU, row LayerNorm and LN<->matmul kernels
(8, 9 and 11) and the `fused_film` route of the 2-D blocks, against the JAX
package in fp32 on the CPU.

On the CPU each wrapper runs its plain version. The plain versions are held
to 1e-5 against the XLA references (`_xla_reference`, `_ln_xla`,
`_lnmm_xla`, `_mmln_xla`) and to 2e-5 against the Pallas bodies in interpret
mode; the autograd Functions' gradients to `jax.grad` of the JAX entry
points (1e-5 of each gradient's largest value); the gates to the JAX shape
conditions. `Block`, `ResnetBlock` and a dim-128 `Unet` built with
`fused_film=True` are held to the JAX modules under `IMAGEN_TPU_FUSED_FILM=1`
(1e-4), with a count showing every norm went the fused way. The CUDA kernels
themselves are held to the plain versions in `tests/test_torch_cuda.py`.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_bridge import load_block, load_into, max_abs, randn, random_params, rng, t

import imagen_tpu.ops.fused_norm as jfn
from imagen_tpu.models import blocks as jb
from imagen_tpu.models.unet2d import Unet as JUnet
from imagen_tpu_torch.models import blocks
from imagen_tpu_torch.ops import fused_norm as fn
from imagen_tpu_torch.utils.port_weights import state_dict_from_jax

import imagen_tpu_torch as it

TOL = 1e-5
PALLAS_TOL = 2e-5
EPS = 1e-5


def _film_inputs(seed, c, b=2, hw=8):
    r = rng(seed)
    return (randn(r, b, hw, hw, c), 1. + randn(r, c, scale=0.1), randn(r, b, c, scale=0.5),
            randn(r, b, c, scale=0.5))


@pytest.mark.parametrize('c', [128, 256])
@pytest.mark.parametrize('film', [True, False], ids=['film', 'no_film'])
def test_film_plain_version_matches_xla_and_pallas(c, film):
    x, gamma, scale, shift = _film_inputs(0, c)
    if not film:   # the JAX route hands the kernel zeros where there is no scale_shift
        scale, shift = np.zeros_like(scale), np.zeros_like(shift)
    jx, jg, js, jh = map(jnp.asarray, (x, gamma, scale, shift))
    xla = jfn._xla_reference(jx, jg, js[:, None, None, :], jh[:, None, None, :])
    pallas = jfn._forward(jx, jg, js, jh, interpret=True)
    mine = fn.fused_film_norm(t(x), t(gamma), *((t(scale), t(shift)) if film else ()))
    assert mine.shape == x.shape
    assert max_abs(mine, xla) <= TOL
    assert max_abs(mine, pallas) <= PALLAS_TOL


@pytest.mark.parametrize('c', [128, 256])
@pytest.mark.parametrize('stable', [False, True], ids=['plain', 'stable'])
def test_layernorm_plain_version_matches_xla_and_pallas(c, stable):
    r = rng(1)
    x, g = randn(r, 4, 16, c) + 0.5, 1. + randn(r, c, scale=0.1)
    jx, jg = jnp.asarray(x), jnp.asarray(g)
    mine = fn.fused_layernorm(t(x), t(g), stable, EPS)
    assert max_abs(mine, jfn._ln_xla(jx, jg, stable, EPS)) <= TOL
    assert max_abs(mine, jfn._ln_forward(jx, jg, stable, EPS, interpret=True)) <= PALLAS_TOL


@pytest.mark.parametrize('k,n', [(128, 256), (256, 128)])
def test_ln_matmul_plain_versions_match_xla_and_pallas(k, n):
    r = rng(2)
    x, w = randn(r, 4, 16, k), randn(r, k, n, scale=k ** -0.5)   # w (k, n), the JAX layout
    gk, gn = 1. + randn(r, k, scale=0.1), 1. + randn(r, n, scale=0.1)
    y = randn(r, 4, 16, k)
    jx, jw, jgk, jgn, jy = map(jnp.asarray, (x, w, gk, gn, y))
    lnmm = fn.fused_ln_matmul(t(x), t(gk), t(w.T), EPS)
    mmln = fn.fused_matmul_ln(t(y), t(w.T), t(gn), EPS)
    assert lnmm.shape == mmln.shape == (4, 16, n)
    assert max_abs(lnmm, jfn._lnmm_xla(jx, jgk, jw, EPS)) <= TOL
    assert max_abs(lnmm, jfn._lnmm_forward(jx, jgk, jw, EPS, interpret=True)) <= PALLAS_TOL
    assert max_abs(mmln, jfn._mmln_xla(jy, jw, jgn, EPS)) <= TOL
    assert max_abs(mmln, jfn._mmln_forward(jy, jw, jgn, EPS, interpret=True)) <= PALLAS_TOL


def _grads_match(jax_fn, torch_fn, arrays, transposed=()):
    """jax.grad of sum(f * cot) against the port's Function gradients, each
    to TOL of its largest value; `transposed` names inputs whose port layout
    is the JAX one transposed (the weights)."""
    r = rng(3)
    out_shape = jax.eval_shape(jax_fn, *map(jnp.asarray, arrays)).shape
    cot = randn(r, *out_shape)

    def jloss(*a):
        return jnp.sum(jax_fn(*a) * jnp.asarray(cot))

    ref = jax.jit(jax.grad(jloss, argnums=tuple(range(len(arrays)))))(*map(jnp.asarray, arrays))
    leaves = [t(a.T if i in transposed else a).requires_grad_() for i, a in enumerate(arrays)]
    (torch_fn(*leaves) * t(cot)).sum().backward()
    for i, (leaf, grad) in enumerate(zip(leaves, ref)):
        grad = np.asarray(grad).T if i in transposed else np.asarray(grad)
        assert max_abs(leaf.grad, grad) <= TOL * max(1., float(np.abs(grad).max())), i


def test_film_function_gradients_match_jax():
    _grads_match(jfn.fused_film_norm, fn.fused_film_norm, _film_inputs(4, 128))


@pytest.mark.parametrize('stable', [False, True], ids=['plain', 'stable'])
def test_layernorm_function_gradients_match_jax(stable):
    r = rng(5)
    _grads_match(lambda x, g: jfn.fused_layernorm(x, g, stable, EPS),
                 lambda x, g: fn.fused_layernorm(x, g, stable, EPS),
                 (randn(r, 64, 128) + 0.5, 1. + randn(r, 128, scale=0.1)))


def test_ln_matmul_function_gradients_match_jax():
    r = rng(6)
    k, n = 128, 256
    x, w = randn(r, 64, k), randn(r, k, n, scale=k ** -0.5)
    _grads_match(lambda x, g, w: jfn.fused_ln_matmul(x, g, w, EPS),
                 lambda x, g, w: fn.fused_ln_matmul(x, g, w, EPS),
                 (x, 1. + randn(r, k, scale=0.1), w), transposed=(2,))
    _grads_match(lambda x, w, g: jfn.fused_matmul_ln(x, w, g, EPS),
                 lambda x, w, g: fn.fused_matmul_ln(x, w, g, EPS),
                 (x, w, 1. + randn(r, n, scale=0.1)), transposed=(1,))


def test_film_gate():
    """The JAX gate's shape conditions (`blocks.py:88-89`), plus C <= 4096
    and bf16 on CUDA."""
    for c, ndim, silu in itertools.product((64, 128, 384, 3584, 4224), (4, 5), (True, False)):
        shape = (2,) * (ndim - 1) + (c,)
        jax_gate = silu and ndim == 4 and c % 128 == 0
        got = fn.fused_film_available(shape, torch.float32, 'cpu', silu)
        assert got == (jax_gate and c <= fn.ROW_MAX_C), (c, ndim, silu)
    assert fn.fused_film_available((8, 64, 64, 512))
    assert not fn.fused_film_available((8, 64, 64, 512), torch.float32)   # CUDA takes bf16


def test_layernorm_gate():
    """`_ln_forward`'s conditions (c % 128 == 0 and a row block), plus c <= 4096."""
    for rows, c in itertools.product((8, 12, 100, 512, 8192), (64, 128, 1024, 2048, 4096)):
        jax_gate = c % 128 == 0 and jfn._pick_rows_block(rows, c) is not None
        assert fn.fused_layernorm_available(rows, c, torch.float32, 'cpu') == jax_gate, (rows, c)
    assert not fn.fused_layernorm_available(512, 8192, torch.float32, 'cpu')
    assert not fn.fused_layernorm_available(512, 1024, torch.float32)


def test_ln_matmul_gate(monkeypatch):
    """`fused_lnmm_available` is the JAX gate without its backend check: the
    kernel takes every shape it admits (k + n past 6144 too)."""
    monkeypatch.setattr(jax, 'default_backend', lambda: 'tpu')
    for rows, k, n in itertools.product((8, 100, 512, 8192), (128, 256, 512, 1024, 2048, 4096),
                                        (128, 640, 2048, 8192, 16384)):
        jax_gate = jfn.fused_lnmm_available(rows, k, n, jnp.bfloat16)
        assert fn.fused_lnmm_available(rows, k, n, torch.bfloat16, 'cpu') == jax_gate, (rows, k, n)
    assert fn.fused_lnmm_available(512, 256, 8192) and fn.fused_lnmm_available(512, 128, 16384)
    assert not fn.fused_lnmm_available(512, 1024, 640, torch.float32)


@pytest.fixture
def fused_film_env(monkeypatch):
    """The JAX fused route on, and a count of the port's fused norm calls."""
    monkeypatch.setenv('IMAGEN_TPU_FUSED_FILM', '1')
    calls = []
    real = fn.fused_film_norm

    def counted(x, gamma, scale, shift):
        calls.append(x.shape)
        return real(x, gamma, scale, shift)

    monkeypatch.setattr(fn, 'fused_film_norm', counted)
    return calls


def test_block_matches_jax(fused_film_env):
    r = rng(7)
    x, ss = randn(r, 2, 8, 8, 128), randn(r, 2, 1, 1, 256, scale=0.5)
    mod = jb.Block(dim_out=128)
    p = random_params(mod, jnp.asarray(x), seed=8)
    ref = jax.jit(lambda p, x, ss: mod.apply({'params': p}, x, scale_shift=jnp.split(ss, 2, -1)))(
        p, jnp.asarray(x), jnp.asarray(ss))
    mine = load_block(blocks.Block(128, 128, fused_film=True), p, 'final_res_block/block2',
                      'final_res_block.block2.')
    out = mine(t(x), scale_shift=t(ss).chunk(2, dim=-1))
    assert max_abs(out, ref) <= 1e-4
    assert fused_film_env == [(2, 8, 8, 128)]


def test_resnet_block_matches_jax(fused_film_env):
    r = rng(9)
    x, emb = randn(r, 2, 8, 8, 256), randn(r, 2, 32)
    mod = jb.ResnetBlock(dim_out=128, time_cond_dim=32, use_gca=True)
    p = random_params(mod, jnp.asarray(x), jnp.asarray(emb), seed=10)
    ref = jax.jit(lambda p, x, e: mod.apply({'params': p}, x, e))(p, jnp.asarray(x),
                                                                   jnp.asarray(emb))
    mine = load_block(blocks.ResnetBlock(256, 128, time_cond_dim=32, use_gca=True,
                                         fused_film=True), p, 'final_res_block',
                      'final_res_block.')
    assert max_abs(mine(t(x), time_emb=t(emb)), ref) <= 1e-4
    assert fused_film_env == [(2, 8, 8, 256), (2, 8, 8, 128)]   # block1 (no FiLM), block2


UNET_CFG = dict(dim=128, dim_mults=(1, 2), num_resnet_blocks=1, layer_attns=(False, True),
                layer_cross_attns=(False, True), attn_heads=2, attn_dim_head=16,
                text_embed_dim=16, cond_dim=32, max_text_len=8, attn_pool_num_latents=4,
                learned_sinu_pos_emb_dim=4)


def test_unet_matches_jax(fused_film_env):
    """Every Block of a dim-128 Unet (c 128, 256 and 384) on the fused route
    in both packages; the parameter tree is the unfused one."""
    r = rng(11)
    x, time = randn(r, 2, 8, 8, 3), r.rand(2).astype(np.float32)
    emb = randn(r, 2, 8, 16)
    junet = JUnet(**UNET_CFG)
    p = random_params(junet, jnp.asarray(x), jnp.asarray(time), text_embeds=jnp.asarray(emb),
                      seed=12)
    ref = jax.jit(lambda p, x, tm, e: junet.apply({'params': p}, x, tm, text_embeds=e))(
        p, jnp.asarray(x), jnp.asarray(time), jnp.asarray(emb))
    mine = load_into(it.Unet(**UNET_CFG, fused_film=True, device='cpu'), p)
    out = mine(t(x), t(time), text_embeds=t(emb))
    assert max_abs(out, ref) <= 1e-4
    n_blocks = sum(isinstance(m, blocks.Block) for m in mine.modules())
    assert len(fused_film_env) == n_blocks == 22
    assert {s[-1] for s in fused_film_env} == {128, 256, 384}
    plain = it.Unet(**UNET_CFG, device='cpu')
    assert mine.state_dict().keys() == plain.state_dict().keys()
    assert set(state_dict_from_jax(p)) == set(mine.state_dict())
