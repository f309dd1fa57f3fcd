"""The tiling of the LayerNorm<->matmul kernel (`csrc/fused_ln_matmul.cu`) on the CPU.

`lnmm_tiles` is held at the EDM path's site shapes and at rows ragged
against the row tile: the column tile divides n, LN -> matmul groups each
row tile's column tiles into clusters of up to 8, matmul -> LN holds the
whole row in one cluster of 1, 2, 4 or 8 blocks, and what a block asks of
shared memory fits. Every (k, n) the gate admits has a route, the shapes past
the old k + n <= 6144 limit too. The kernel's split arithmetic is emulated in
torch: LN -> matmul's row statistics in two passes (the mean, then the
centred squares), each 64-column x stage normalised and rounded as it
arrives, each column tile's product summed over the K stages in fp32;
matmul -> LN's product of each column tile (a block of the cluster) rounded,
the row's statistics combined from the blocks' partial sums in rank order in
two passes. It is held to the JAX package's `_lnmm_xla` / `_mmln_xla` in
fp32 to 1e-5 of the output's largest value (the split only reorders fp32
sums), and to `_lnmm_forward` / `_mmln_forward` in interpret mode at one
small shape: fp32 to 1e-5, and bf16, rounding where `_lnmm_kernel` /
`_mmln_kernel` round, to 2^-7 of it (a sum taken in another order can flip
one bf16 rounding). The kernel itself is held to the plain version on the
card in `tests/test_torch_cuda.py`, and its own tiling to `lnmm_tiles`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cuda import LNMM_SHAPES, MMLN_SHAPES
from torch_port_bridge import randn, rng, t

import imagen_tpu.ops.fused_norm as jfn
from imagen_tpu_torch.ops import fused_norm as fn

EPS = 1e-3

# the EDM path's sites at batch 8 (BaseUnet64's 32^2, 16^2 and 8^2 attention
# and cross-attention layers, SRUnet256's 32^2) and the tile each takes:
# (rows, k, n) -> (BM, WN, cluster)
LNMM_SITES = {(8192, 1024, 640): (128, 320, 2), (8192, 512, 512): (128, 256, 2),
              (2048, 1536, 640): (128, 128, 1), (512, 2048, 640): (64, 64, 1),
              (512, 2048, 512): (64, 64, 4)}
MMLN_SITES = {(8192, 512, 1024): (128, 256, 4), (2048, 512, 1536): (128, 192, 8),
              (512, 512, 2048): (64, 128, 8), (8192, 512, 512): (128, 256, 2)}


def _bn(tiles):
    return tiles.wg_cols if tiles.rows_tile == 128 else 2 * tiles.wg_cols


def _check_tiles(tiles, rows, n, ln_first):
    bn = _bn(tiles)
    assert tiles.col_tiles * bn == n
    assert tiles.grid == -(-rows // tiles.rows_tile) * tiles.col_tiles
    assert tiles.cluster in fn.FF_CLUSTERS and tiles.col_tiles % tiles.cluster == 0
    if not ln_first and not tiles.staged:
        assert tiles.cluster == tiles.col_tiles   # the whole row in one cluster
    assert tiles.rows_tile // tiles.cluster % 4 == 0   # whole warps share the statistics
    ring = tiles.stages * (tiles.rows_tile + bn) * fn.LNMM_KC * 2
    assert 2 <= tiles.stages <= fn.LNMM_MAX_STAGES and tiles.rows_tile * bn * 2 <= ring
    assert tiles.smem == fn.lnmm_smem(tiles.rows_tile, bn, tiles.stages) <= fn.SMEM_LIMIT


@pytest.mark.parametrize('ln_first,shape', [(True, s) for s in LNMM_SITES]
                         + [(False, s) for s in MMLN_SITES])
def test_lnmm_tiles_at_the_sites(ln_first, shape):
    tiles = fn.lnmm_tiles(*shape, ln_first=ln_first)
    _check_tiles(tiles, shape[0], shape[2], ln_first)
    want = (LNMM_SITES if ln_first else MMLN_SITES)[shape]
    assert (tiles.rows_tile, tiles.wg_cols, tiles.cluster) == want
    assert not tiles.staged


@pytest.mark.parametrize('rows', [1, 77, 300, 8200])
def test_lnmm_tiles_at_ragged_rows(rows):
    for (_, k, n), ln_first in [*((s, True) for s in LNMM_SITES),
                                *((s, False) for s in MMLN_SITES)]:
        _check_tiles(fn.lnmm_tiles(rows, k, n, ln_first), rows, n, ln_first)


def test_every_shape_the_gate_admits_has_a_route():
    """Every (k, n) `fused_lnmm_available` admits (multiples of 128, k n <= 2M
    weights) takes a tile in both variants, among them the shapes past the old
    k + n <= 6144 limit; matmul -> LN takes the staged route only where no
    tile splits n over 1, 2, 4 or 8 blocks. Widths off the kernel's grid have
    none."""
    past_old_limit = 0
    for k in range(128, 16385, 128):
        for n in range(128, 16385, 128):
            if not fn.fused_lnmm_available(8192, k, n):
                continue
            past_old_limit += k + n > 6144
            for ln_first in (True, False):
                tiles = fn.lnmm_tiles(8192, k, n, ln_first)
                _check_tiles(tiles, 8192, n, ln_first)
                assert not (ln_first and tiles.staged), (k, n)
    assert past_old_limit > 0
    for k, n in ((256, 8192), (128, 16384)):
        assert fn.fused_lnmm_available(512, k, n)
        assert not fn.lnmm_tiles(512, k, n).staged and fn.lnmm_tiles(512, k, n, False).staged
    assert fn.lnmm_tiles(8, 96, 256) is None and fn.lnmm_tiles(8, 256, 320) is None
    assert fn.lnmm_tiles(0, 256, 256) is None


def test_the_card_tests_reach_every_cluster_size():
    """The shapes `tests/test_torch_cuda.py` runs on the card reach clusters
    of 1, 2, 4 and 8 blocks in both variants, and the staged route."""
    assert {fn.lnmm_tiles(*s).cluster for s in LNMM_SHAPES} == {1, 2, 4, 8}
    mmln = [fn.lnmm_tiles(*s, ln_first=False) for s in MMLN_SHAPES]
    assert {m.cluster for m in mmln if not m.staged} == {1, 2, 4, 8}
    assert any(m.staged for m in mmln)


def _rank_order(parts):
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def lnmm_emulation(x, g, w, eps, tiles):
    """LN -> matmul as the kernel splits it, rounding to x's dtype where it
    rounds to bf16; w (n, k). Rows are independent, so the zero rows TMA adds
    past the last change nothing."""
    dt, k = x.dtype, x.shape[-1]
    xf = x.float()
    mean = xf.sum(-1, keepdim=True) / k
    rstd = torch.rsqrt(((xf - mean) ** 2).sum(-1, keepdim=True) / k + eps)
    bn = _bn(tiles)
    out = []
    for c in range(tiles.col_tiles):
        cols = slice(c * bn, (c + 1) * bn)
        acc = 0.
        for s in range(0, k, fn.LNMM_KC):
            ks = slice(s, s + fn.LNMM_KC)
            a = ((xf[:, ks] - mean) * rstd * g[ks].float()).to(dt).float()
            acc = acc + a @ w[cols, ks].to(dt).float().T
        out.append(acc.to(dt))
    return torch.cat(out, -1)


def mmln_emulation(x, w, g, eps, tiles):
    """matmul -> LN as the cluster splits it (the staged route: one part, the
    whole row), rounding to x's dtype where the kernel rounds to bf16."""
    dt, n = x.dtype, w.shape[0]
    bn = n if tiles.staged else _bn(tiles)
    cols = [slice(c, c + bn) for c in range(0, n, bn)]
    parts = [(x.float() @ w[c].to(dt).float().T).to(dt).float() for c in cols]
    mean = _rank_order([p.sum(-1, keepdim=True) for p in parts]) / n
    var = _rank_order([((p - mean) ** 2).sum(-1, keepdim=True) for p in parts]) / n
    rstd = torch.rsqrt(var + eps)
    return torch.cat([((p - mean) * rstd * g[c].float()).to(dt) for p, c in zip(parts, cols)], -1)


def _inputs(seed, rows, k, n, ln_first):
    r = rng(seed)
    return (randn(r, rows, k), 1. + randn(r, k if ln_first else n, scale=0.1),
            randn(r, n, k, scale=k ** -0.5))


# clusters of 2, 4 and 8 blocks in both variants, BM 64 and 128, ragged rows,
# the staged route
EMULATED = [(True, 200, 512, 768), (True, 72, 256, 1536), (True, 136, 128, 2048),
            (False, 264, 512, 640), (False, 200, 512, 1024), (False, 136, 128, 2048),
            (False, 136, 128, 896)]


@pytest.mark.parametrize('ln_first,rows,k,n', EMULATED)
def test_split_arithmetic_matches_jax_in_fp32(ln_first, rows, k, n):
    x, g, w = _inputs(50, rows, k, n, ln_first)
    tiles = fn.lnmm_tiles(rows, k, n, ln_first)
    assert tiles.cluster > 1 or tiles.staged
    jx, jg, jw = jnp.asarray(x), jnp.asarray(g), jnp.asarray(w.T)
    if ln_first:
        mine = lnmm_emulation(t(x), t(g), t(w), EPS, tiles)
        ref = jax.jit(jfn._lnmm_xla, static_argnums=3)(jx, jg, jw, EPS)
    else:
        mine = mmln_emulation(t(x), t(w), t(g), EPS, tiles)
        ref = jax.jit(jfn._mmln_xla, static_argnums=3)(jx, jw, jg, EPS)
    ref = np.asarray(ref)
    assert float(np.abs(mine.numpy() - ref).max()) <= 1e-5 * float(np.abs(ref).max())


@pytest.mark.parametrize('ln_first', [True, False], ids=['ln_matmul', 'matmul_ln'])
def test_split_arithmetic_matches_the_pallas_kernel(ln_first):
    """One small shape, a cluster of two blocks: the emulation against
    `_lnmm_kernel` / `_mmln_kernel` in interpret mode, fp32 and bf16."""
    rows, k, n = 64, 256, 512
    x, g, w = _inputs(51, rows, k, n, ln_first)
    tiles = fn.lnmm_tiles(rows, k, n, ln_first)
    assert tiles.cluster > 1
    for dtype, jdtype, tol in ((torch.float32, jnp.float32, 1e-5),
                               (torch.bfloat16, jnp.bfloat16, 2. ** -7)):
        tx, tw = t(x).to(dtype), t(w).to(dtype)
        jx, jg, jw = jnp.asarray(x, jdtype), jnp.asarray(g), jnp.asarray(w.T, jdtype)
        if ln_first:
            mine = lnmm_emulation(tx, t(g), tw, EPS, tiles)
            pallas = jfn._lnmm_forward(jx, jg, jw, EPS, interpret=True)
        else:
            mine = mmln_emulation(tx, tw, t(g), EPS, tiles)
            pallas = jfn._mmln_forward(jx, jw, jg, EPS, interpret=True)
        pallas = np.asarray(pallas.astype(jnp.float32))
        err = float(np.abs(mine.float().numpy() - pallas).max())
        assert err <= tol * float(np.abs(pallas).max()), (dtype, err)
