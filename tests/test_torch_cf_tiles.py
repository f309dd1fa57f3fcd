"""The plan of the tiny-cout channel-first conv (`csrc/conv2d_same_cf.cu`) on the CPU.

`cf_plan` is held at the SR-1024 final conv and at the shapes of the card's
tests: the widest strip whose window, ring of staging rows and output row fit
in shared memory, the weights held where they fit, the route straight from x
and channel groups where the ring does not fit. The kernel's streaming is
emulated in torch: each block's run of strip-rows cut as the kernel cuts
them (a run crossing from one strip into the next), each input row fetched
as the 16-byte aligned superset of its segment (8 bf16 values) and read at
its offset inside it, re-laid into a window zero outside the image and past
cin, and multiplied into the running sums of the k output rows it feeds, the
oldest emitted. It is held to the JAX package's `_xla_reference_cf` and, at
one shape `_pick_blocks_cf` accepts, to `_forward_cf` in interpret mode, in
fp32 to 1e-5 of the output's largest value (the emulation only reorders
fp32 sums). The kernel itself is held to the plain version on the card in
`tests/test_torch_cuda.py`, and its own plan to `cf_plan`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_cuda import CF_CASES
from torch_port_bridge import randn, rng, t

import imagen_tpu.ops.conv2d as jc2d
from imagen_tpu_torch.ops import conv2d as c2d


def test_cf_plan_at_the_final_convs():
    """The SR-1024 final conv (cin 131) and the JAX gate's cin 128: 128-column
    strips, every channel in the window, three rows in flight, the weights
    held, one run of 124 rows a block on each of 132 SMs."""
    for cin in (131, 128):
        plan = c2d.cf_plan(2, 1024, 1024, cin, 3, sms=132)
        assert plan[:4] == (128, -(-cin // 16), 3, True)
        assert plan.grid == 132
        assert plan.smem == c2d.cf_smem(128, -(-cin // 16), 3, True, cin, 3) <= c2d.SMEM_LIMIT


@pytest.mark.parametrize('shape,cout,k', CF_CASES)
def test_cf_plan_fits_and_prefers_wide_strips(shape, cout, k):
    b, H, W, cin = shape
    plan = c2d.cf_plan(b, H, W, cin, k)
    ch16 = -(-cin // 16)
    assert plan.smem == c2d.cf_smem(*plan[:4], cin, k) <= c2d.SMEM_LIMIT
    assert plan.strip_w in (16, 32, 64, 128) and 1 <= plan.chunks <= ch16
    assert plan.staging in (0, 2, 3) and (plan.staging == 0 or plan.chunks == ch16)
    if plan.staging == 0:   # no strip held every channel beside a ring
        assert plan.strip_w == 16
        assert c2d.cf_smem(16, ch16, 2, False, cin, k) > c2d.SMEM_LIMIT
    elif plan.strip_w < 128:
        assert c2d.cf_smem(2 * plan.strip_w, ch16, 2, False, cin, k) > c2d.SMEM_LIMIT
    rows = b * -(-W // plan.strip_w) * H
    assert 1 <= plan.grid <= max(1, rows // c2d.CF_MIN_RUN)


def test_the_card_tests_reach_every_route():
    """The shapes `tests/test_torch_cuda.py` runs on the card take the ring
    with the weights held and read through L1, the route straight from x, and
    more than one channel group."""
    plans = [(c2d.cf_plan(*shape, k), shape[3]) for shape, _, k in CF_CASES]
    assert {(p.staging > 0, p.wsmem) for p, _ in plans} >= {(True, True), (True, False),
                                                          (False, False)}
    assert any(p.chunks < -(-cin // 16) for p, cin in plans)


def cf_emulation(x, w, bias, plan):
    """The kernel's streaming in fp32: runs of strip-rows, aligned-superset
    row fetches, the re-laid window, running sums of the k output rows."""
    b, H, W, cin = x.shape
    k, cout = w.shape[0], w.shape[3]
    p, sw = k // 2, plan.strip_w
    strips_x = -(-W // sw)
    flat = x.reshape(-1)
    out = torch.full((b, cout, H, W), float('nan'))
    bias = torch.zeros(cout) if bias is None else bias
    total = b * strips_x * H
    for blk in range(plan.grid):
        s, end = total * blk // plan.grid, total * (blk + 1) // plan.grid
        while s < end:   # one strip's rows [ya, yb) of the run
            strip, ya = divmod(s, H)
            yb = min(H, ya + end - s)
            bb, x0 = divmod(strip, strips_x)
            x0 *= sw
            xl, xr = max(0, x0 - p), min(W, x0 + sw + p)
            acc = [bias[:, None].repeat(1, sw) for _ in range(k)]   # (cout, sw) each
            for r in range(ya - p, yb + p):
                if 0 <= r < H:
                    start = ((bb * H + r) * W + xl) * cin
                    a, e = start // 8 * 8, -(-(start + (xr - xl) * cin) // 8) * 8
                    staging = F.pad(flat[a:e], (0, 16))   # the copy and its slack
                    window = torch.zeros(sw + 2 * p, cin)
                    for q in range(sw + 2 * p):
                        xc = x0 - p + q
                        if 0 <= xc < W:
                            o = start - a + (xc - xl) * cin
                            window[q] = staging[o:o + cin]
                    for j in range(k):   # slot j: output row r - p + j, tap k - 1 - j
                        dy = k - 1 - j
                        for dx in range(k):
                            acc[j] = acc[j] + w[dy, dx].T @ window[dx:dx + sw].T
                y = r - p
                if ya <= y < yb:
                    n = min(sw, W - x0)
                    out[bb, :, y, x0:x0 + n] = acc[0][:, :n]
                acc = acc[1:] + [bias[:, None].repeat(1, sw)]
            s = strip * H + yb
    return out


def _inputs(seed, shape, cout, k):
    r = rng(seed)
    cin = shape[-1]
    return (randn(r, *shape), randn(r, k, k, cin, cout, scale=(k * k * cin) ** -0.5),
            randn(r, cout, scale=0.1))


# an odd cin with runs crossing into the next strip and ragged strips (W 150:
# 128 + 22 columns; few SMs, so several runs), cin 1-3 at k 1, 3 and 5
EMULATED = [((2, 20, 150, 131), 3, 3, 3), ((1, 18, 40, 1), 2, 3, 2),
            ((1, 17, 33, 2), 3, 5, 2), ((1, 16, 20, 3), 8, 1, 1)]


@pytest.mark.parametrize('shape,cout,k,sms', EMULATED)
def test_streaming_matches_xla_in_fp32(shape, cout, k, sms):
    x, w, bias = _inputs(60, shape, cout, k)
    plan = c2d.cf_plan(*shape, k, sms=sms)
    mine = cf_emulation(t(x), t(w), t(bias), plan)
    ref = np.asarray(jax.jit(jc2d._xla_reference_cf)(jnp.asarray(x), jnp.asarray(w),
                                                      jnp.asarray(bias)))
    assert float(np.abs(mine.numpy() - ref).max()) <= 1e-5 * float(np.abs(ref).max())


def test_streaming_matches_the_pallas_kernel():
    """One shape `_pick_blocks_cf` accepts (8-row blocks of 128 columns),
    against `_kernel_cf` in interpret mode."""
    shape, cout, k = (1, 8, 128, 16), 3, 3
    assert jc2d._pick_blocks_cf(8, 128, 16, cout, k, 4) is not None
    x, w, bias = _inputs(61, shape, cout, k)
    mine = cf_emulation(t(x), t(w), t(bias), c2d.cf_plan(*shape, k, sms=2))
    ref = np.asarray(jc2d._forward_cf(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                                      interpret=True))
    assert float(np.abs(mine.numpy() - ref).max()) <= 1e-5 * float(np.abs(ref).max())


def test_packed_weights_layout():
    """(k, k, cin, cout) as (k^2, ceil(cin / 16), 8, 24): tap, 16-channel
    chunk, output, channel; zero past cin, cout and 16."""
    w = t(randn(rng(62), 3, 3, 20, 3))
    packed = c2d._packed_cf_weights(w)
    assert packed.shape == (9, 2, 8, 24) and packed.dtype == torch.bfloat16
    wb = w.to(torch.bfloat16)
    assert torch.equal(packed[4, 1, 2, :4], wb[1, 1, 16:20, 2])
    assert torch.equal(packed[7, 0, 0, :16], wb[2, 1, :16, 0])
    assert not packed[:, 1, :, 4:].any() and not packed[:, :, 3:].any()
    assert not packed[..., 16:].any()
