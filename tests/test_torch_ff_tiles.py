"""The tiling of the fused feedforward kernel (`csrc/fused_feedforward.cu`) on the CPU.

`ff_tiles` is held at every site shape of the paths and at rows ragged
against the 64-row tile: the cluster's blocks split hid into slices of 128,
256 or 512 and k into multiples of 64, what a block asks of shared memory
fits. The
kernel's split arithmetic is emulated in torch: the hidden row computed slice
by slice as the cluster's blocks compute it, LN1's statistics combined from
the slices' partial sums in rank order in two passes (the mean, then the
centred squares), each slice's partial second product, and the partials
summed in rank order before the one rounding. It is held to the JAX
package's `_ff_xla` and to `_ff_forward` in interpret mode: in fp32 to 1e-5
of the output's largest value (the split only reorders fp32 sums), and in
bf16, rounding where `_ff_kernel` rounds, to 2^-7 of it (a sum taken in
another order can flip one bf16 rounding of the hidden row or the output,
one step of bf16's 8-bit mantissa). The weight cache of `FeedForward` is
held to its stamp. Every shape the gate admits has a route: the cluster
kernel or, where `ff_tiles` refuses, the staged route, whose arithmetic is
the emulation with one slice. The kernel itself is held to the plain version
on the card in `tests/test_torch_cuda.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_port_bridge import randn, rng, t

import imagen_tpu.ops.fused_norm as jfn
from imagen_tpu_torch.models import blocks
from imagen_tpu_torch.ops import fused_norm as fn

# (k, hid) of the paths' sites and the cluster ff_tiles picks by rows, the
# sites' (BaseUnet64's 32^2 TransformerBlock, 8192 rows at batch 8; the
# Perceivers, b x 36 rows) and rows ragged against the 64-row tile
SITE_CLUSTERS = {(512, 1024): {8: 8, 72: 8, 200: 8, 288: 8, 8192: 2, 8200: 2},
                 (128, 512): {r: 2 for r in (8, 72, 144, 200, 288, 8200)},
                 (512, 2048): {8: 8, 72: 8, 144: 8, 200: 8, 288: 8, 8200: 4}}


@pytest.mark.parametrize('k,hid,rows', [(k, hid, rows) for (k, hid), by in SITE_CLUSTERS.items()
                                        for rows in by])
def test_ff_tiles_at_the_sites_and_ragged_rows(k, hid, rows):
    tiles = fn.ff_tiles(rows, k, hid)
    assert tiles.cluster == SITE_CLUSTERS[k, hid][rows]
    assert tiles.cluster * tiles.hid_slice == hid and tiles.hid_slice in fn.FF_SLICES
    assert k % (64 * tiles.cluster) == 0    # each block's output columns: whole 64-column boxes
    assert tiles.row_tiles == -(-rows // fn.FF_ROWS)
    assert tiles.grid == tiles.row_tiles * tiles.cluster
    assert tiles.smem == fn.ff_smem(k, tiles.hid_slice, tiles.stages) <= fn.SMEM_LIMIT
    assert tiles.stages >= 3
    assert (tiles.stages == fn.FF_MAX_STAGES
            or fn.ff_smem(k, tiles.hid_slice, tiles.stages + 1) > fn.SMEM_LIMIT)


def test_ff_tiles_prefers_filled_sms_then_wide_slices():
    # 8192 rows: 128 row tiles fill the card at any split; the 512-column slice wins
    assert fn.ff_tiles(8192, 512, 1024)[:2] == (2, 512)
    assert fn.ff_tiles(8448, 128, 512)[:2] == (1, 512)
    # one row tile: eight blocks of 128 columns before four of 256
    assert fn.ff_tiles(8, 512, 1024)[:2] == (8, 128)
    assert fn.ff_tiles(200, 384, 128)[:2] == (1, 128)
    assert fn.ff_tiles(72, 256, 256)[:2] == (2, 128)


@pytest.mark.parametrize('rows,k,hid', [(64, 1024, 1024), (64, 640, 128), (64, 512, 384),
                                        (64, 128, 4096), (64, 128, 2048), (0, 512, 1024)])
def test_ff_tiles_refuses_what_the_kernel_does_not_take(rows, k, hid):
    """k past 512 or not in the cluster kernel's instantiations; hid not 128,
    256 or 512 times 1, 2, 4 or 8; k / cluster short of 64 columns (hid 2048
    at k 128 needs 4 blocks of 32 columns); no rows. The staged route takes
    each of these shapes."""
    assert fn.ff_tiles(rows, k, hid) is None
    assert fn.ff_staged_takes(k, hid)


@pytest.mark.parametrize('rows', [8, 72, 8200])
def test_every_shape_the_gate_admits_has_a_route(rows):
    """Every (k, hid) that `fused_feedforward_available` admits on CUDA (k
    and hid multiples of 128, 2 k hid bf16 weights within 4 MB) runs: on the
    cluster kernel or on the staged route. Neither takes a shape the gate
    refuses for its widths."""
    admitted = 0
    for k in range(64, 8193, 64):
        for hid in range(64, 8193, 64):
            takes = fn.ff_tiles(rows, k, hid) is not None or fn.ff_staged_takes(k, hid)
            if fn.fused_feedforward_available(rows, k, hid):
                admitted += 1
                assert takes, (k, hid)
            elif k % 128 or hid % 128:
                assert not takes, (k, hid)
    assert admitted == sum(64 // a for a in range(1, 65))   # k = 128 a, hid = 128 b, a b <= 64


def ff_emulation(x, g0, w0, g1, w1, eps, cluster, hid_slice):
    """The kernel's split arithmetic, rounding to x's dtype where it rounds
    to bf16; w0 (hid, k) and w1 (k, hid) as the module stores them. The
    staged route is one slice of the whole hidden row (cluster 1). Rows are
    independent, so the zero rows TMA adds past the last change nothing."""
    dt = x.dtype
    cl, hs = cluster, hid_slice
    hid = w0.shape[0]
    xp = x.float()
    mean = xp.sum(-1, keepdim=True) / xp.shape[-1]
    var = ((xp - mean) ** 2).sum(-1, keepdim=True) / xp.shape[-1]
    xn = ((xp - mean) * torch.rsqrt(var + eps) * g0.float()).to(dt).float()
    cols = [slice(r * hs, (r + 1) * hs) for r in range(cl)]
    h = [F.gelu((xn @ w0[c].to(dt).float().T).to(dt).float()).to(dt).float() for c in cols]

    def rank_order(parts):
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total

    mean1 = rank_order([s.sum(-1, keepdim=True) for s in h]) / hid
    var1 = rank_order([((s - mean1) ** 2).sum(-1, keepdim=True) for s in h]) / hid
    rstd1 = torch.rsqrt(var1 + eps)
    parts = [((s - mean1) * rstd1 * g1[c].float()).to(dt).float() @ w1[:, c].to(dt).float().T
             for s, c in zip(h, cols)]
    return rank_order(parts).to(dt)


def _ff_inputs(seed, rows, k, hid):
    r = rng(seed)
    return (randn(r, rows, k), 1. + randn(r, k, scale=0.1), randn(r, hid, k, scale=k ** -0.5),
            1. + randn(r, hid, scale=0.1), randn(r, k, hid, scale=hid ** -0.5))


# each cluster size the tiler picks, each slice (128, 256, 512), k 128 to
# 512, ragged rows
EMULATED = [(72, 128, 512), (200, 512, 1024), (72, 512, 2048), (200, 384, 128),
            (300, 256, 1024), (8448, 128, 512)]


@pytest.mark.parametrize('rows,k,hid', EMULATED)
def test_split_arithmetic_matches_jax_in_fp32(rows, k, hid):
    x, g0, w0, g1, w1 = _ff_inputs(40, rows, k, hid)
    tiles = fn.ff_tiles(rows, k, hid)
    mine = ff_emulation(*map(t, (x, g0, w0, g1, w1)), 1e-3, tiles.cluster, tiles.hid_slice)
    jargs = (jnp.asarray(x), jnp.asarray(g0), jnp.asarray(w0.T), jnp.asarray(g1),
             jnp.asarray(w1.T))
    xla = np.asarray(jax.jit(jfn._ff_xla, static_argnums=5)(*jargs, 1e-3))
    pallas = np.asarray(jfn._ff_forward(*jargs, 1e-3, interpret=True))
    scale = float(np.abs(xla).max())
    assert float(np.abs(mine.numpy() - xla).max()) <= 1e-5 * scale
    assert float(np.abs(mine.numpy() - pallas).max()) <= 1e-5 * scale


# the cluster kernel's splits, then shapes only the staged route takes: ff_mult
# 2 at width 384 (a default Unet's 384-wide stage), k past 512, hid 5 x 256
@pytest.mark.parametrize('rows,k,hid', [(72, 128, 512), (200, 512, 1024), (72, 512, 2048),
                                        (72, 384, 768), (64, 1024, 1024), (64, 640, 1280)])
def test_split_arithmetic_matches_the_pallas_kernel_in_bf16(rows, k, hid):
    """bf16 in and out: the emulation against `_ff_kernel` in interpret mode,
    which rounds at the same places."""
    x, g0, w0, g1, w1 = _ff_inputs(41, rows, k, hid)
    bf = jnp.bfloat16
    tiles = fn.ff_tiles(rows, k, hid)
    cluster, hid_slice = (1, hid) if tiles is None else (tiles.cluster, tiles.hid_slice)
    mine = ff_emulation(t(x).to(torch.bfloat16), t(g0), t(w0).to(torch.bfloat16), t(g1),
                        t(w1).to(torch.bfloat16), 1e-3, cluster, hid_slice).float()
    pallas = jfn._ff_forward(jnp.asarray(x, bf), jnp.asarray(g0), jnp.asarray(w0.T, bf),
                             jnp.asarray(g1), jnp.asarray(w1.T, bf), 1e-3, interpret=True)
    pallas = np.asarray(pallas.astype(jnp.float32))
    assert float(np.abs(mine.numpy() - pallas).max()) <= 2. ** -7 * float(np.abs(pallas).max())


def test_feedforward_keeps_its_bf16_weights_until_they_change():
    """`_packed_weights` is made once and handed back while both Linear
    weights keep their identity, version and data; an in-place update, a
    replaced parameter and `.to()` each drop it."""
    ff = blocks.FeedForward(128, mult=2., dtype=torch.bfloat16)
    first = ff._packed_weights()
    assert all(p.dtype == torch.bfloat16 and p.is_contiguous() for p in first)
    assert torch.equal(first[0], ff[1].weight.to(torch.bfloat16))
    assert torch.equal(first[1], ff[4].weight.to(torch.bfloat16))
    assert ff._packed_weights() is first
    with torch.no_grad():
        ff[4].weight.add_(1.)
    second = ff._packed_weights()
    assert second is not first and torch.equal(second[1], ff[4].weight.to(torch.bfloat16))
    ff[1].weight = torch.nn.Parameter(ff[1].weight.detach() * 2.)
    third = ff._packed_weights()
    assert third is not second and torch.equal(third[0], ff[1].weight.to(torch.bfloat16))
    ff.to(torch.float64)
    assert ff._kept is None
    assert ff._packed_weights()[0].dtype == torch.bfloat16
