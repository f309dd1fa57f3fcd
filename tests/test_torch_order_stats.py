"""Dynamic thresholding's two order statistics, `nonneg_order_stats`.

- The port's function on the CPU (its `kthvalue` route) against the JAX
  package's radix select (`imagen_tpu.ops.tensor_utils.nonneg_order_stats`)
  on the magnitudes of the same rows, bit for bit: random rows, rows whose
  ties at x_(lo) cover rank lo + 1 and rows whose ties end at rank lo, rows
  of zeros (-0.0 among them) and of one magnitude, lo = 0 and lo = n - 2,
  one and three rows, a bf16 input, and x_(lo+1) one ulp or one octave
  above x_(lo).
- The digit passes of the CUDA kernel (`csrc/order_stats.cu`), emulated in
  torch: 11 + 10 + 10 bits of the magnitude patterns, each pass's histogram
  summed over the blocks' slices of the row, the rank carried into the next
  pass, and x_(lo+1) from the ties, the last histogram's next bin or the
  least pattern above the last prefix's range; held to the same JAX results
  at the same rows, and each of the three ways to x_(lo+1) reached.
- `order_stats_blocks` at the benchmark's rows.
"""
import jax
import numpy as np
import pytest
import torch

from imagen_tpu.ops import tensor_utils as jtu

from imagen_tpu_torch.ops import tensor_utils as tu

J_ORDER_STATS = jax.jit(jtu.nonneg_order_stats, static_argnums=1)


def _rows(kind, b, n, lo, seed):
    """(b, n) float32 rows, signed, of the case `kind`."""
    r = np.random.default_rng(seed)
    sign = np.where(r.random((b, n)) < 0.5, -1., 1.).astype(np.float32)
    if kind == 'random':
        return r.standard_normal((b, n)).astype(np.float32) * 2.5
    if kind == 'ties_cover':   # seven magnitudes: ties span every rank
        return r.integers(0, 7, (b, n)).astype(np.float32) * 0.5 * sign
    if kind in ('ties_end_at_lo', 'next_ulp', 'next_octave'):
        vals = np.arange(1, n + 1, dtype=np.float32) * 0.25
        if kind == 'ties_end_at_lo':   # x_(lo-2) = x_(lo-1) = x_(lo) < x_(lo+1)
            vals[lo - 2:lo + 1] = vals[lo - 2]
        else:   # x_(lo+1) shares x_(lo)'s top 21 bits, or lies in the next octave
            vals[lo] = 1.
            vals[lo + 1] = np.nextafter(np.float32(1.), np.float32(2.)) if kind == 'next_ulp' else 2.
            vals[:lo] = np.linspace(0., 0.5, lo, dtype=np.float32)
            vals[lo + 2:] = 4.
        return np.stack([r.permutation(vals) for _ in range(b)]) * sign
    if kind == 'zeros':
        return np.zeros((b, n), np.float32) * sign   # -0.0 where the sign is negative
    if kind == 'equal':
        return np.full((b, n), 1.5, np.float32) * sign
    raise ValueError(kind)


def _lo(spec, n):
    return {'q95': tu.quantile_position(n, 0.95)[0], 'first': 0, 'last': n - 2}.get(spec, spec)


CASES = [
    ('random', 3, 1000, 'q95', torch.float32),
    ('random', 1, 4096, 'q95', torch.float32),
    ('random', 3, 500, 'first', torch.float32),
    ('random', 1, 500, 'last', torch.float32),
    ('random', 3, 1000, 'q95', torch.bfloat16),
    ('ties_cover', 3, 1000, 'q95', torch.float32),
    ('ties_cover', 1, 2, 'first', torch.float32),
    ('ties_end_at_lo', 3, 100, 94, torch.float32),
    ('zeros', 3, 257, 'q95', torch.float32),
    ('zeros', 1, 3, 'last', torch.float32),
    ('equal', 3, 300, 'q95', torch.float32),
    ('equal', 1, 300, 'last', torch.bfloat16),
    ('next_ulp', 3, 200, 189, torch.float32),
    ('next_octave', 1, 200, 189, torch.float32),
]
IDS = [f'{k}-b{b}-n{n}-lo_{lo}-{str(d)[6:]}' for k, b, n, lo, d in CASES]


def _jax_bits(x, lo):
    """The JAX package's statistics of |x| (x a torch tensor), as uint32 patterns."""
    v_lo, v_hi = J_ORDER_STATS(np.abs(x.float().numpy()), lo)
    return np.asarray(v_lo).view(np.uint32), np.asarray(v_hi).view(np.uint32)


def _bits(v):
    return v.numpy().view(np.uint32)


@pytest.mark.parametrize('kind,b,n,lo,dtype', CASES, ids=IDS)
def test_order_stats_match_jax_bit_for_bit(kind, b, n, lo, dtype):
    lo = _lo(lo, n)
    x = torch.from_numpy(_rows(kind, b, n, lo, seed=n + b)).to(dtype)
    v_lo, v_hi = tu.nonneg_order_stats(x, lo)
    assert v_lo.dtype == v_hi.dtype == torch.float32 and v_lo.shape == v_hi.shape == (b,)
    want_lo, want_hi = _jax_bits(x, lo)
    np.testing.assert_array_equal(_bits(v_lo), want_lo)
    np.testing.assert_array_equal(_bits(v_hi), want_hi)


# --- the CUDA kernel's arithmetic, emulated --------------------------------------------

DIGITS = ((11, 20), (10, 10), (10, 0))   # (bits, shift) of each pass


def _emulated(x, lo, blocks, ways):
    """`csrc/order_stats.cu`'s passes over each row of x, its blocks taking
    `blocks` slices; counts in `ways` how each x_(lo+1) was found."""
    pats = x.float().view(torch.int32).long() & 0x7fffffff
    out = []
    for row in pats:
        slices = row.tensor_split(blocks)
        prefix, rank = 0, lo
        for bits, shift in DIGITS:
            size = 1 << bits
            hist = sum(torch.bincount((c[(c >> (shift + bits)) == prefix] >> shift) & (size - 1),
                                      minlength=size) for c in slices)
            before = hist.cumsum(0) - hist
            digit = int(((before <= rank) & (rank < before + hist)).nonzero()[0, 0])
            left, tied = rank - int(before[digit]), int(hist[digit])
            last_prefix, prefix, rank = prefix, (prefix << bits) | digit, rank - int(before[digit])
        above = min((int(c[(c >> 10) > last_prefix].min()) for c in slices
                     if ((c >> 10) > last_prefix).any()), default=None)
        later = (hist[digit + 1:] > 0).nonzero()
        if left + 1 < tied:
            v_hi, way = prefix, 'ties'
        elif len(later):
            v_hi, way = (last_prefix << 10) | (digit + 1 + int(later[0, 0])), 'next bin'
        else:
            v_hi, way = above, 'above'
        ways[way] += 1
        out.append((prefix, v_hi))
    v = torch.tensor(out, dtype=torch.int32).view(torch.float32)
    return v[:, 0], v[:, 1]


def test_kernel_passes_emulated_match_jax():
    ways = dict.fromkeys(('ties', 'next bin', 'above'), 0)
    for kind, b, n, lo, dtype in CASES:
        lo = _lo(lo, n)
        x = torch.from_numpy(_rows(kind, b, n, lo, seed=n + b)).to(dtype)
        want_lo, want_hi = _jax_bits(x, lo)
        for blocks in (1, 3):
            v_lo, v_hi = _emulated(x, lo, blocks, ways)
            np.testing.assert_array_equal(_bits(v_lo), want_lo, err_msg=f'{kind} {blocks}')
            np.testing.assert_array_equal(_bits(v_hi), want_hi, err_msg=f'{kind} {blocks}')
    assert min(ways.values()) > 0, ways


def test_order_stats_grid_follows_the_row():
    sms = 132
    assert tu.order_stats_blocks(1, 3 * 1024 ** 2, sms) == 384   # SR-1024: the whole card
    assert tu.order_stats_blocks(8, 3 * 256 ** 2, sms) == 24
    assert tu.order_stats_blocks(8, 3 * 64 ** 2, sms) == 2
    assert tu.order_stats_blocks(2, 2, sms) == 1
    assert tu.order_stats_blocks(1000, 10 ** 6, sms) == 1


def test_order_stats_refuse_a_rank_without_a_successor():
    x = torch.rand(2, 10)
    for lo in (-1, 9, 10):
        with pytest.raises(ValueError):
            tu.nonneg_order_stats(x, lo)
