"""The port's fused temporal LayerNorm fold and out-norm unfold (kernels 12
and 13) against the JAX package, in fp32 on the CPU.

On the CPU `fused_ln_transpose` and `fused_norm_untranspose` run their plain
versions. Both are held to 1e-5 against the XLA references (`_ln_t_xla`,
`_norm_ut_xla`) and the Pallas kernels in interpret mode, at c = 128 and 256;
the autograd Functions' gradients against `jax.grad` of the JAX entry
points. `TemporalAttention` on the fused route is held to the JAX module
under `IMAGEN_TPU_TEMPORAL_FUSED_LN=1`: a residual added twice, or not at
all, would show in its output. The CUDA kernels themselves are held to the
plain versions in `tests/test_torch_cuda.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_bridge import load_block, max_abs, randn, random_params, rng, t

import imagen_tpu.ops.flash_attention as jfa
import imagen_tpu.ops.temporal_layout as jtl
from imagen_tpu.models import video_blocks as jvb
from imagen_tpu_torch.models import video_blocks as vb
from imagen_tpu_torch.ops import temporal_layout as tl
from imagen_tpu_torch.utils.port_weights import state_dict_from_jax

TOL = 1e-5
EPS = 1e-5          # the fp32 LayerNorm eps
SHAPE = (2, 4, 8, 8)  # b, f, h, w


def _inputs(seed, c):
    r = rng(seed)
    b, f, h, w = SHAPE
    return (randn(r, b, f, h, w, c), randn(r, b * h * w, f, c, scale=2.),
            1. + randn(r, c, scale=0.1))


@pytest.mark.parametrize('c', [128, 256])
def test_plain_versions_match_xla_and_pallas(monkeypatch, c):
    x, out, g = _inputs(0, c)
    jx, jout, jg = map(jnp.asarray, (x, out, g))
    monkeypatch.setattr(jtl, '_INTERPRET', True)
    refs_fold = (jtl._ln_t_xla(jx, jg, EPS), jtl.fused_ln_transpose(jx, jg, EPS))
    refs_unfold = (jtl._norm_ut_xla(jout, jx, jg, EPS),
                   jtl.fused_norm_untranspose(jout, jx, jg, EPS))

    folded = tl.fused_ln_transpose(t(x), t(g), EPS)
    unfolded = tl.fused_norm_untranspose(t(out), t(x), t(g), EPS)
    b, f, h, w = SHAPE
    assert folded.shape == (b * h * w, f, c) and unfolded.shape == x.shape
    for ref in refs_fold:
        assert max_abs(folded, ref) <= TOL
    for ref in refs_unfold:
        assert max_abs(unfolded, ref) <= TOL


def test_function_gradients_match_jax():
    x, out, g = _inputs(1, 128)
    r = rng(2)
    cot_fold, cot_unfold = randn(r, *out.shape), randn(r, *x.shape)

    def jloss(x, out, g):
        folded = jtl.fused_ln_transpose(x, g, EPS)
        unfolded = jtl.fused_norm_untranspose(out, x, g, EPS)
        return (jnp.sum(folded * jnp.asarray(cot_fold))
                + jnp.sum(unfolded * jnp.asarray(cot_unfold)))

    ref = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(*map(jnp.asarray, (x, out, g)))
    leaves = [t(a).requires_grad_() for a in (x, out, g)]
    xs, outs, gs = leaves
    loss = ((tl.fused_ln_transpose(xs, gs, EPS) * t(cot_fold)).sum()
            + (tl.fused_norm_untranspose(outs, xs, gs, EPS) * t(cot_unfold)).sum())
    loss.backward()
    for name, leaf, grad in zip(('x', 'out', 'g'), leaves, ref):
        assert max_abs(leaf.grad, grad) <= TOL * max(1., float(np.abs(grad).max())), name


def test_gate():
    shape = (*SHAPE, 128)
    assert tl.temporal_layout_available(shape)
    assert tl.temporal_layout_available((*SHAPE, 256))
    assert not tl.temporal_layout_available((*SHAPE, 64))         # the JAX gate's c >= 128
    assert tl.temporal_layout_available(shape, torch.float32, 'cpu')
    assert not tl.temporal_layout_available((*SHAPE, 64), torch.float32, 'cpu')
    assert not tl.temporal_layout_available(shape, torch.float32)  # CUDA takes bf16
    assert not tl.temporal_layout_available((8, 8, 8, 128))        # 4-D
    assert not tl.temporal_layout_available((*SHAPE, 132))         # c % 8
    assert not tl.temporal_layout_available((*SHAPE, 4096))        # over one warp's row


@pytest.mark.parametrize('fused', [True, False], ids=['fused', 'unfused'])
def test_temporal_attention_matches_jax(monkeypatch, fused):
    """Causal temporal attention with the position bias at c = 128 over 4
    frames of 8 x 8 pixels; both packages on the fused route or both off.
    Every gain is drawn away from its init, so the zero-init out-norm does
    not hide the attention branch."""
    monkeypatch.setenv('IMAGEN_TPU_TEMPORAL_FUSED_LN', '1' if fused else '0')
    monkeypatch.setattr(jtl, '_INTERPRET', True)
    monkeypatch.setattr(jfa, '_INTERPRET', False)
    c, heads, dim_head = 128, 2, 16
    x = randn(rng(3), *SHAPE, c)
    cot = randn(rng(4), *SHAPE, c)
    jmod = jvb.TemporalAttention(dim_head=dim_head, heads=heads)
    params = random_params(jmod, jnp.asarray(x), seed=5)

    def jloss(p, x):
        out = jmod.apply({'params': p}, x)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, ref), ref_grads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))

    mine = vb.TemporalAttention(c, dim_head=dim_head, heads=heads, fused_ln=fused)
    load_block(mine, params, 'init_temporal_attn', 'init_temporal_attn.', video=True)
    xs = t(x).requires_grad_()
    out = mine(xs)
    (out * t(cot)).sum().backward()
    assert max_abs(out, ref) <= TOL
    assert max_abs(xs.grad, ref_grads[1]) <= 1e-4
    # the gradient tree maps onto the port's parameters as the weights did
    ref_sd = state_dict_from_jax({'init_temporal_attn': ref_grads[0]}, video=True)
    named = dict(mine.named_parameters())
    assert {'init_temporal_attn.' + k for k in named} == set(ref_sd)
    for name, p in named.items():
        ref_g = ref_sd['init_temporal_attn.' + name]
        assert max_abs(p.grad, ref_g) <= 1e-4 * max(1., float(ref_g.abs().max())), name
