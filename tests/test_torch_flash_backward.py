"""The port's flash-attention backward against the JAX package, fp32, on the CPU.

The plain backward (`flash_rows_backward_reference`, what the autograd
Function runs on a CPU tensor) is held to `_flash_rows_backward_impl` with
its Pallas kernels in interpret mode, on both JAX tiers: the one-shot kernel
(the whole K/V resident) and the two streamed kernels (forced by
`_ONESHOT_MAX_NK = 0`). The Function's gradients, on the cosine path
including the gains', are held to `jax.grad` of the JAX entry points in
interpret mode. Ragged nk (77) and a head dim that is not a multiple of 16
(40) are what the CUDA kernel pads and masks. Tolerance 1e-5 of max(1, the
gradient's max |value|): fp32 sums of a few hundred terms in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_bridge import max_abs, randn, rng, t

import imagen_tpu.ops.flash_attention as jfa
from imagen_tpu_torch.ops import flash_attention as fa

TOL = 1e-5
B, ROWS, NK, D = 2, 256, 77, 40


def rel_err(a, ref):
    return max_abs(a, ref) / max(1., float(np.abs(np.asarray(ref)).max()))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jfa, '_INTERPRET', True)
    return jfa


def _normalised(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


@pytest.mark.parametrize('tier', ['oneshot', 'stream'])
def test_plain_backward_matches_pallas_tiers(interpret, monkeypatch, tier):
    if tier == 'stream':
        monkeypatch.setattr(jfa, '_ONESHOT_MAX_NK', 0)
    r = rng(0)
    q, k = _normalised(randn(r, B, ROWS, D)), _normalised(randn(r, B, NK, D))
    v, do = randn(r, B, NK, D), randn(r, B, ROWS, D)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    out, lse = jfa._flash_rows_forward(jq, jk, jv, 8., return_stats=True, interpret=True)
    delta = jfa._delta(jdo, out)
    ref = jfa._flash_rows_backward_impl(jq, jk, jv, jdo, lse, delta, 8., interpret=True)
    # the port's forward gives the same lse
    _, mine_lse = fa.flash_rows_reference(t(q), t(k), t(v), 8., return_lse=True)
    assert rel_err(mine_lse, lse) <= TOL
    mine = fa.flash_rows_backward(t(q), t(k), t(v), t(do), t(np.asarray(lse)),
                                  t(np.asarray(delta)), 8.)
    for name, a, b in zip(('dq', 'dk', 'dv'), mine, ref):
        assert a.shape == b.shape, name
        assert rel_err(a, b) <= TOL, name


def _grads_torch(fn, inputs, cot):
    leaves = [t(x).requires_grad_() for x in inputs]
    (fn(*leaves) * t(cot)).sum().backward()
    return [x.grad for x in leaves]


def test_cosine_function_gradients_match_jax_grad(interpret):
    r = rng(1)
    q, k, v = randn(r, B, ROWS, D), randn(r, B, NK, D), randn(r, B, NK, D)
    qs, ks = 1. + randn(r, D, scale=0.1), 1. + randn(r, D, scale=0.1)
    cot = randn(r, B, ROWS, D)

    def loss(q, k, v, qs, ks):
        return jnp.sum(jfa.flash_cosine_mqa_rows(q, k, v, qs, ks, 8.) * cot)

    ref = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (q, k, v, qs, ks)))
    mine = _grads_torch(lambda *a: fa.flash_cosine_mqa_rows(*a, 8.), (q, k, v, qs, ks), cot)
    for name, a, b in zip(('dq', 'dk', 'dv', 'dq_scale', 'dk_scale'), mine, ref):
        assert a.shape == b.shape, name
        assert rel_err(a, b) <= TOL, name


def test_plain_function_gradients_match_jax_grad(interpret):
    r = rng(2)
    q, k = _normalised(randn(r, B, ROWS, D)), _normalised(randn(r, B, NK, D))
    v, cot = randn(r, B, NK, D), randn(r, B, ROWS, D)

    def loss(q, k, v):
        return jnp.sum(jfa.flash_mqa_rows(q, k, v, 8.) * cot)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    mine = _grads_torch(lambda *a: fa.flash_mqa_rows(*a, 8.), (q, k, v), cot)
    for name, a, b in zip(('dq', 'dk', 'dv'), mine, ref):
        assert rel_err(a, b) <= TOL, name


def test_no_grad_forward_keeps_nothing():
    """Serving runs under no_grad: the entry point returns a plain tensor with
    no graph, and with grad enabled it is the autograd Function."""
    r = rng(3)
    q, k, v = (t(randn(r, 1, n, 16)).requires_grad_() for n in (128, 40, 40))
    qs, ks = t(np.ones(16, np.float32)), t(np.ones(16, np.float32))
    with torch.no_grad():
        out = fa.flash_cosine_mqa_rows(q, k, v, qs, ks, 8.)
    assert out.grad_fn is None
    out = fa.flash_cosine_mqa_rows(q, k, v, qs, ks, 8.)
    assert type(out.grad_fn).__name__ == '_FlashRowsBackward'
