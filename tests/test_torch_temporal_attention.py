"""The port's temporal-attention kernel module (kernel 4) against the JAX package.

On the CPU `flash_grouped_cosine` runs its plain PyTorch version, which is
held in fp32 to 1e-5 against both TPU kernels it replaces, each run in
interpret mode and through its XLA reference:
- the grouped kernel (`flash_grouped_cosine`, `_grouped_packed_naive`), at a
  G > 1 pixel grouping whose block-diagonal bias tile converts to the
  per-pixel table;
- the rows-packed kernel (`flash_temporal_rows`, `_temporal_rows_naive`),
  whose (pixel, frame, head)-ordered tile converts the same way.
Gradients through the autograd Function are held to `jax.grad` of the grouped
entry point, and `VideoAttention` (causal, relative position bias) to the JAX
module on its grouped route and on its XLA route. The CUDA kernel itself is
held to the plain version in `tests/test_torch_cuda.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_bridge import load_block, max_abs, randn, random_params, rng, t

import imagen_tpu.ops.flash_attention as jfa
from imagen_tpu.models import video_blocks as jvb
from imagen_tpu_torch.models import video_blocks as vb
from imagen_tpu_torch.ops import flash_attention as fa

TOL = 1e-5
F, H, D = 4, 2, 16     # frames, heads, dim_head
NKL = F + 1            # keys per pixel, the null key first


def _causal(n, nk):
    return np.triu(np.ones((n, nk), bool), nk - n + 1)


def _inputs(seed, pixels):
    r = rng(seed)
    return (randn(r, pixels, F, H * D), randn(r, pixels, NKL, D), randn(r, pixels, NKL, D),
            1. + randn(r, D, scale=0.1), 1. + randn(r, D, scale=0.1), randn(r, H, F, NKL))


def test_plain_matches_grouped_kernel(monkeypatch):
    """G = 4 pixels per program, 3 programs: the port's per-pixel layout is the
    same memory as the packed one, and the tile's diagonal block is the table."""
    monkeypatch.setattr(jfa, '_INTERPRET', True)
    G, B = 4, 3
    q, k, v, qs, ks, bias = _inputs(0, G * B)
    tile = jfa.build_grouped_bias(jnp.asarray(bias), jnp.asarray(_causal(F, NKL)), G)
    jargs = (jnp.asarray(q.reshape(B, G * F, H * D)), jnp.asarray(k.reshape(B, G * NKL, D)),
             jnp.asarray(v.reshape(B, G * NKL, D)), jnp.asarray(qs), jnp.asarray(ks), tile)
    pallas = jfa.flash_grouped_cosine(*jargs, 8., H)
    xla = jfa._grouped_packed_naive(*jargs, 8., H)

    table = np.asarray(tile).reshape(H, G, F, G, NKL)[:, 0, :, 0, :]
    mine = fa.flash_grouped_cosine(t(q), t(k), t(v), t(qs), t(ks), t(table), 8., H)
    assert mine.shape == (G * B, F, H * D)
    assert max_abs(mine, np.asarray(pallas).reshape(G * B, F, H * D)) <= TOL
    assert max_abs(mine, np.asarray(xla).reshape(G * B, F, H * D)) <= TOL
    # the port's build_grouped_bias gives that table
    built = fa.build_grouped_bias(t(bias), torch.from_numpy(_causal(F, NKL)))
    assert max_abs(built, table) == 0.


def test_plain_matches_rows_kernel(monkeypatch):
    """The rows-packed kernel (row 5): Gr pixels share one 128-key tile whose
    rows run (pixel, frame, head)."""
    monkeypatch.setattr(jfa, '_INTERPRET', True)
    Gr, B = 8, 2
    q, k, v, qs, ks, bias = _inputs(1, Gr * B)
    tile = jfa.build_rows_bias(jnp.asarray(bias), jnp.asarray(_causal(F, NKL)), Gr)
    jargs = (jnp.asarray(q.reshape(B, Gr * F, H * D)), jnp.asarray(k.reshape(B, Gr * NKL, D)),
             jnp.asarray(v.reshape(B, Gr * NKL, D)), jnp.asarray(qs), jnp.asarray(ks), tile)
    pallas = jfa.flash_temporal_rows(*jargs, 8., H)
    xla = jfa._temporal_rows_naive(*jargs, 8., H)

    table = np.asarray(tile)[:F * H, :NKL].reshape(F, H, NKL).transpose(1, 0, 2)
    mine = fa.flash_grouped_cosine(t(q), t(k), t(v), t(qs), t(ks), t(table), 8., H)
    assert max_abs(mine, np.asarray(pallas).reshape(Gr * B, F, H * D)) <= TOL
    assert max_abs(mine, np.asarray(xla).reshape(Gr * B, F, H * D)) <= TOL


def test_function_gradients_match_jax(monkeypatch):
    """Gradients of q, k, v, both gains and the bias (through build_grouped_bias, so
    the masked entries get none) against jax.grad of the grouped entry point."""
    monkeypatch.setattr(jfa, '_INTERPRET', True)
    G, B = 2, 2
    q, k, v, qs, ks, bias = _inputs(2, G * B)
    cot = randn(rng(3), G * B, F, H * D)
    causal = _causal(F, NKL)

    def jloss(q, k, v, qs, ks, bias):
        tile = jfa.build_grouped_bias(bias, jnp.asarray(causal), G)
        out = jfa.flash_grouped_cosine(q.reshape(B, G * F, H * D), k.reshape(B, G * NKL, D),
                                       v.reshape(B, G * NKL, D), qs, ks, tile, 8., H)
        return jnp.sum(out.reshape(G * B, F, H * D) * jnp.asarray(cot))

    ref = jax.jit(jax.grad(jloss, argnums=tuple(range(6))))(
        *map(jnp.asarray, (q, k, v, qs, ks, bias)))
    leaves = [t(a).requires_grad_() for a in (q, k, v, qs, ks, bias)]
    table = fa.build_grouped_bias(leaves[5], torch.from_numpy(causal))
    out = fa.flash_grouped_cosine(*leaves[:5], table, 8., H)
    (out * t(cot)).sum().backward()
    for name, leaf, g in zip(('q', 'k', 'v', 'q_scale', 'k_scale', 'bias'), leaves, ref):
        assert max_abs(leaf.grad, g) <= TOL, name


def test_gate():
    # the video config's sites: 16 frames x 8 heads, 17 keys, d 64
    assert fa.grouped_temporal_available(16, 8, 17, 64)
    assert fa.grouped_temporal_available(16, 8, 17, 64, torch.float32, 'cpu')
    assert not fa.grouped_temporal_available(16, 8, 17, 64, torch.float32)  # CUDA takes bf16
    assert not fa.grouped_temporal_available(32, 8, 33, 64)   # 256 rows
    assert not fa.grouped_temporal_available(4, 2, 65, 64)    # flattened keys
    assert not fa.grouped_temporal_available(16, 8, 17, 160)


# --- VideoAttention -------------------------------------------------------------------------

@pytest.mark.parametrize('interpret', [True, False], ids=['grouped', 'xla'])
def test_video_attention_matches_jax(monkeypatch, interpret):
    """Causal temporal attention with the DynamicPositionBias and null bias,
    over 4 frames of 32 pixels: the JAX module on its grouped route
    (interpret) or its XLA route, the port on its kernel route."""
    monkeypatch.setattr(jfa, '_INTERPRET', interpret)
    dim, pixels = 12, 32
    jmod = jvb.VideoAttention(dim_head=D, heads=H, causal=True, rel_pos_bias=True,
                              init_zero=False)
    x = randn(rng(4), pixels, F, dim)
    params = random_params(jmod, jnp.asarray(x), seed=5)
    ref = jax.jit(lambda p, x: jmod.apply({'params': p}, x))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    mine = vb.VideoAttention(dim, dim_head=D, heads=H, causal=True, rel_pos_bias=True)
    load_block(mine, params, 'init_temporal_attn/attn', 'init_temporal_attn.fn.fn.')
    with torch.no_grad():
        out = mine(t(x))
    assert max_abs(out, ref) <= 1e-4
