"""The work list of the CrossEmbed stem kernel (`csrc/cross_embed_stem.cu`) on the CPU.

`stem_sets` and `stem_plan` are held at the six site shapes of the paths and
at ragged ones: the largest kernel's sets lead the work list, each scale's
channels go in as few sets as the registers and shared memory allow, the
packed weights of each set start where the plan says, and what a block asks
of shared memory fits. The kernel's arithmetic is emulated in fp32 from the
packed weights: the input padded to 8 channels; for each set, each group of
stacked output rows and each band row, each tap column's window of
consecutive weight blocks (zero blocks where a stacked row has no tap)
times the tap's shifted window of the halo'd band; the bias added once;
each set's channels past d dropped. It is held to the JAX package's XLA
reference, and for one shape its Pallas kernel in interpret mode, to 1e-5
(the inputs are bf16 values, so packing the weights in bf16 is exact, and
the sums differ only in fp32 order). The kernel itself is held to the plain
version on the card in `tests/test_torch_cuda.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_port_bridge import max_abs, randn, rng, t

import imagen_tpu.ops.stem_conv as jstem
from imagen_tpu_torch.ops import stem_conv as stem

TOL = 1e-5
KERNELS = (3, 7, 15)

# (b, H, W, c) and the scales' channels at the six site shapes: the SR-1024
# stem; SRUnet256's at batch 4 and 8; BaseUnet64's (CFG batch 8); the video
# U-Net's at 32 and 64 frames. Then the sets `stem_sets` makes of them, as
# (k, n0, n), largest kernel first.
SITES = [((2, 1024, 1024, 6), (64, 32, 32)), ((4, 256, 256, 6), (64, 32, 32)),
         ((8, 256, 256, 6), (64, 32, 32)), ((8, 64, 64, 3), (256, 128, 128)),
         ((32, 64, 64, 3), (32, 16, 16)), ((64, 64, 64, 3), (32, 16, 16))]
SETS = {(64, 32, 32): [(15, 0, 32), (7, 0, 32), (3, 0, 64)],
        (256, 128, 128): [(15, 0, 32), (15, 32, 32), (15, 64, 32), (15, 96, 32),
                          (7, 0, 128), (3, 0, 128), (3, 128, 128)],
        (32, 16, 16): [(15, 0, 16), (7, 0, 16), (3, 0, 32)]}


@pytest.mark.parametrize('shape,ds', SITES)
def test_stem_plan_at_the_sites(shape, ds):
    b, H, W, c = shape
    plan = stem.stem_plan(b, H, W, KERNELS, ds)
    assert [(st.k, st.n0, st.n) for st in plan.sets] == SETS[ds]
    assert plan.tiles == b * -(-H // stem.STEM_ROWS) * -(-W // stem.STEM_TW)
    assert plan.items == len(plan.sets) * plan.tiles
    assert plan.grid == min(plan.items, stem.SMS) == stem.SMS
    assert plan.smem <= stem.SMEM_LIMIT
    coffs = dict(zip(KERNELS, (0, ds[0], ds[0] + ds[1])))
    woff = 0
    for st in plan.sets:
        assert st.d == ds[KERNELS.index(st.k)] and st.coff == coffs[st.k]
        assert st.woff == woff and st.n in stem.STEM_NS
        assert stem.stem_weight_bytes(st.k, st.n) <= stem.STEM_WEIGHT_BUDGET
        woff += stem.stem_weight_bytes(st.k, st.n) // 2


def test_stem_plan_on_ragged_and_odd_shapes():
    """Tiles past H and W (2 x 36 x 100: 5 row tiles of 8, 2 column tiles of
    64), d short of n (20 of 32, 10 of 16), one scale, four scales, and a
    grid no larger than the work list."""
    plan = stem.stem_plan(2, 36, 100, KERNELS, (20, 10, 10))
    assert [(st.k, st.n0, st.n, st.coff) for st in plan.sets] == [
        (15, 0, 16, 30), (7, 0, 16, 20), (3, 0, 32, 0)]
    assert (plan.tiles, plan.items, plan.grid) == (20, 60, 60)
    one = stem.stem_plan(1, 12, 28, (9,), (24,))
    assert [(st.k, st.n) for st in one.sets] == [(9, 32)] and one.grid == 2
    four = stem.stem_plan(2, 36, 44, (1, 5, 9, 13), (8, 8, 8, 16))
    assert [st.k for st in four.sets] == [13, 9, 5, 1]
    assert [st.coff for st in four.sets] == [24, 16, 8, 0]


def stem_emulation(x, ws, bias):
    """The kernel's sums, in fp32, from `pack_stem_weights`: for each set and
    each band row R of a group of stacked output rows, the RP consecutive
    weight blocks from block k - 1 - R of each tap column (zero blocks where
    R - j is no tap row), times the tap's shifted band window."""
    b, H, W, c = x.shape
    ks, ds = [w.shape[0] for w in ws], [w.shape[3] for w in ws]
    packed = stem.pack_stem_weights(ws).float()
    x8 = F.pad(x.float(), (0, 8 - c))
    out = torch.full((b, H, W, sum(ds)), float('nan'))
    for st in stem.stem_sets(ks, ds):
        k, n, p = st.k, st.n, st.k // 2
        rp, columns = stem.stem_stacked_rows(n), 2 * stem.stem_tap_pairs(st.k)
        blocks = packed[st.woff:st.woff + stem.stem_weight_bytes(k, n) // 2].reshape(-1, n, 8)
        band = F.pad(x8, (0, 0, p, columns - 1 - p, p, p + rp - 1))   # the halo, zero columns
        acc = torch.zeros(b, H, W, n)
        for r0 in range(0, H, rp):                          # stacked output rows r0 .. r0 + rp - 1
            rows = min(rp, H - r0)
            for R in range(k + rp - 1):                     # band rows r0 + R
                for dx in range(columns):
                    first = rp - 1 + dx * (k + rp - 1) + k - 1 - R
                    win = band[:, r0 + R, dx:dx + W]        # (b, W, 8)
                    for j in range(rows):
                        acc[:, r0 + j] += win @ blocks[first + j].T
        m, lo = min(n, st.d - st.n0), st.coff + st.n0
        out[..., lo:lo + m] = acc[..., :m] + bias[lo:lo + m].float()
    return out


# small shapes of the sites' kinds: the SR stems' scales, held to the XLA
# reference and the Pallas kernel; then, to the XLA reference alone (the
# Pallas kernel's interpret mode takes about 9 s a call), BaseUnet64's,
# whose 15 x 15 scale takes four sets and its 3 x 3 scale two, odd channel
# offsets at c = 8, one scale with d short of n, and four scales
EMULATED = [((2, 16, 16, 6), KERNELS, (64, 32, 32), True),
            ((1, 8, 8, 3), KERNELS, (256, 128, 128), False),
            ((1, 20, 12, 8), (1, 5), (7, 9), False), ((1, 12, 28, 6), (9,), (24,), False),
            ((1, 12, 20, 3), (1, 5, 9, 13), (8, 8, 8, 16), False)]


@pytest.mark.parametrize('shape,ks,ds,pallas', EMULATED)
def test_kernel_arithmetic_on_packed_weights_matches_jax(shape, ks, ds, pallas):
    r = rng(50)
    c = shape[-1]

    def bf16_values(a):   # exact in the bf16 packing
        return np.asarray(t(a).to(torch.bfloat16).float())

    x = bf16_values(randn(r, *shape))
    ws = [bf16_values(randn(r, k, k, c, d, scale=(k * k * c) ** -0.5)) for k, d in zip(ks, ds)]
    bias = bf16_values(randn(r, sum(ds), scale=0.1))
    mine = stem_emulation(t(x), [t(w) for w in ws], t(bias))
    jx, jws, jbias = jnp.asarray(x), [jnp.asarray(w) for w in ws], jnp.asarray(bias)
    assert max_abs(mine, jax.jit(jstem._xla_reference)(jx, jws, jbias)) <= TOL
    if pallas:
        assert max_abs(mine, jstem._forward(jx, jws, jbias, interpret=True)) <= TOL
