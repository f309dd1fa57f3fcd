"""The split of the flash backward's dK/dV pass over the query rows, on the CPU.

The CUDA backward splits the R rows of its dK/dV pass into S slices, one
grid dimension, writes each slice's fp32 partial dK and dV, and sums the
partials in slice order before rounding once. Here: the host function that
picks S at the paths' shapes and at the edges, the slices it implies, and
the plain backward summed over those slices in fp32 (the kernel's order of
sums), held to the JAX backward (`_flash_rows_backward_impl` with its Pallas
kernels in interpret mode) within the tolerance of the whole-R plain
version in `test_torch_flash_backward.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_bridge import max_abs, randn, rng, t

import imagen_tpu.ops.flash_attention as jfa
from imagen_tpu_torch.ops import flash_attention as fa

TOL = 1e-5
H100_SMS = 132


@pytest.mark.parametrize('b,rows,nk,splits', [
    (8, 8192, 1063, 4),     # BaseUnet64 at 32^2, CFG batch 8: 72 blocks -> 288
    (4, 32768, 4097, 2),    # the video mid_attn in training: 132 -> 264
    (2, 32768, 4097, 4),    # mid_attn at b 2: 66 -> 264
    (8, 1024, 4097, 1),     # 264 blocks fill the SMs twice already
    (64, 1024, 1063, 1),
    (1, 64, 1, 1),          # one row tile: nothing to split
    (1, 512, 1, 2),         # 8 row tiles, at least 4 a slice
    (1, 8192, 63, 32),      # one key block: as many slices as 4-tile runs allow
])
def test_bwd_splits_at_path_and_edge_shapes(b, rows, nk, splits):
    got = fa.bwd_splits(b, rows, nk, H100_SMS)
    assert got == splits
    blocks = b * -(-nk // fa.BWD_KEYS)
    tiles = -(-rows // fa.BWD_ROWS)
    assert 1 <= got <= tiles
    # the grid fills the SMs twice, unless the slices would drop below 4 tiles
    assert blocks * got >= 2 * H100_SMS or got == max(1, tiles // 4)


@pytest.mark.parametrize('rows,splits', [(8192, 4), (200, 3), (130, 2), (64, 1), (1000, 5)])
def test_split_row_ranges_cover_the_rows_in_order(rows, splits):
    ranges = fa.split_row_ranges(rows, splits)
    assert len(ranges) == splits
    assert ranges[0][0] == 0 and ranges[-1][1] == rows
    for (lo, hi), (nxt, _) in zip(ranges, ranges[1:]):
        assert lo < hi == nxt and lo % fa.BWD_ROWS == 0


def _partial_dkdv(q, k, v, do, lse, delta, scale):
    """fp32 dK, dV of rows q, do with the plain backward's arithmetic,
    unrounded: P rounded to dO's dtype before P^T dO, dS to q's before dS^T q."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (scale * fa.LOG2E)
    p = torch.exp2(s - lse[..., None])
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    return torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float()), dv


def split_backward(q, k, v, do, lse, delta, scale, splits):
    """(dq, dk, dv) with dK and dV summed over the slices of R in slice order
    in fp32 and rounded once, as the kernel's two passes compute them."""
    dq = fa.flash_rows_backward_reference(q, k, v, do, lse, delta, scale)[0]
    dk = dv = 0.
    for lo, hi in fa.split_row_ranges(q.shape[1], splits):
        pk, pv = _partial_dkdv(q[:, lo:hi], k, v, do[:, lo:hi], lse[:, lo:hi],
                               delta[:, lo:hi], scale)
        dk, dv = dk + pk, dv + pv
    return dq, dk.to(k.dtype), dv.to(v.dtype)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jfa, '_INTERPRET', True)
    return jfa


@pytest.mark.parametrize('splits', [1, 3])
def test_split_backward_matches_jax(interpret, splits):
    """Rows 200 (a ragged last tile), nk 77, d 40, as the kernel pads them."""
    r = rng(20)
    b, rows, nk, d = 2, 200, 77, 40
    q, k = (a / np.linalg.norm(a, axis=-1, keepdims=True)
            for a in (randn(r, b, rows, d), randn(r, b, nk, d)))
    v, do = randn(r, b, nk, d), randn(r, b, rows, d)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    # 200 rows: row blocks of 8, which the JAX tiers take only when asked
    out, lse = jfa._flash_rows_forward(jq, jk, jv, 8., block_q=8, return_stats=True,
                                       interpret=True)
    delta = jfa._delta(jdo, out)
    ref = jfa._flash_rows_backward_impl(jq, jk, jv, jdo, lse, delta, 8., block_q=8,
                                        interpret=True)
    mine = split_backward(t(q), t(k), t(v), t(do), t(np.asarray(lse)), t(np.asarray(delta)),
                          8., splits)
    for name, a, b_ in zip(('dq', 'dk', 'dv'), mine, ref):
        assert a.shape == b_.shape, name
        assert max_abs(a, b_) / max(1., float(np.abs(np.asarray(b_)).max())) <= TOL, name


def test_split_sum_in_bf16_stays_within_the_whole_r_rounding():
    """In bf16 the slices' fp32 sum differs from the whole-R plain backward
    only by fp32 reassociation, far inside one bf16 rounding of the result."""
    r = rng(21)
    b, rows, nk, d = 1, 256, 65, 16
    q, k = (fa.l2norm_scale(t(randn(r, b, n, d)), torch.ones(d)) for n in (rows, nk))
    v, do = t(randn(r, b, nk, d)), t(randn(r, b, rows, d))
    q, k, v, do = (x.to(torch.bfloat16) for x in (q, k, v, do))
    out, lse = fa.flash_rows_reference(q.float(), k.float(), v.float(), 8., return_lse=True)
    delta = fa._delta(do, out)
    whole = fa.flash_rows_backward_reference(q, k, v, do, lse, delta, 8.)
    split = split_backward(q, k, v, do, lse, delta, 8., 4)
    for a, b_ in zip(split, whole):
        ulp = b_.float().abs().clamp(min=1e-3) * 2. ** -7
        assert bool(((a.float() - b_.float()).abs() <= ulp).all())
