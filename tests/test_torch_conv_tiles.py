"""The tiling of the 3x3 conv kernel (`csrc/conv2d_same.cu`) on the CPU.

`conv_tiles` is held at every site shape of the paths: what it asks of shared
memory fits a block, and it gives every SM of the H100 a tile. The kernel's
decomposition is emulated in fp32: the output tiles `conv_tiles` chooses,
for each 64-channel chunk an input band read at signed coordinates with zeros
outside the tensor, and for each tap the 64 consecutive band pixels of a
flattened band row window times that tap's 64 x 128 weight slab. The sum is
held to the JAX package's XLA conv and its Pallas kernel in interpret mode.
The kernel itself is held to the plain version on the card in
`tests/test_torch_cuda.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_bridge import max_abs, randn, rng, t

import imagen_tpu.ops.conv2d as jc2d
from imagen_tpu_torch.ops import conv2d as c2d

TOL = 1e-5

# (b, H, W, cin) -> cout at every SameConv3x3 site the gate admits on the
# paths: BaseUnet64 (CFG batch 8), SRUnet256 (batch 8) and SRUnet1024 (batch 2)
SITES = [((8, 64, 64, 1024), 512), ((8, 128, 128, 128), 128), ((8, 128, 128, 256), 128),
         ((8, 256, 256, 128), 128), ((2, 64, 64, 1024), 1024), ((2, 64, 64, 2048), 1024),
         ((2, 128, 128, 512), 512), ((2, 128, 128, 1024), 512), ((2, 256, 256, 256), 256),
         ((2, 256, 256, 512), 256), ((2, 512, 512, 128), 128), ((2, 512, 512, 256), 128),
         ((2, 1024, 1024, 128), 128)]


@pytest.mark.parametrize('shape,cout', SITES)
def test_conv_tiles_fit_and_fill_the_card(shape, cout):
    tiles = c2d.conv_tiles(*shape, cout)
    assert tiles.smem == c2d.conv_smem(tiles.rows, tiles.stages) <= c2d.SMEM_LIMIT
    assert c2d.conv_smem(tiles.rows, tiles.stages + 1) > c2d.SMEM_LIMIT
    assert tiles.rows == 4 and tiles.stages >= 3
    b, H, W, _ = shape
    assert tiles.tiles == b * -(-H // 4) * -(-W // c2d.TILE_W) * -(-cout // c2d.TILE_N)
    assert tiles.grid == min(tiles.tiles, c2d.SMS) == c2d.SMS


def test_conv_tiles_narrow_the_tile_before_leaving_sms_idle():
    small = c2d.conv_tiles(1, 7, 100, 64, 70)
    assert (small.rows, small.grid, small.tiles) == (2, 8, 8)
    wide = c2d.conv_tiles(1, 128, 64, 64, 384)   # 96 tiles of 4 rows, 192 of 2
    assert (wide.rows, wide.grid, wide.tiles) == (2, c2d.SMS, 192)
    assert wide.stages > c2d.conv_tiles(2, 64, 64, 1024, 1024).stages


def test_kernel_weight_copies_at_most_once():
    r = rng(30)
    w = t(randn(r, 3, 3, 32, 24)).to(torch.bfloat16)
    assert c2d.kernel_weight(w).data_ptr() == w.data_ptr()   # contiguous bf16: no copy
    module_weight = t(randn(r, 24, 32, 3, 3))                 # SameConv3x3's (O, I, kh, kw)
    view = module_weight.permute(2, 3, 1, 0)
    kw = c2d.kernel_weight(view)
    assert kw.is_contiguous() and kw.dtype == torch.bfloat16 and kw.shape == (3, 3, 32, 24)
    assert torch.equal(kw, view.to(torch.bfloat16))
    # as the path hands it over: the module's bf16 cast, then the permuted view
    bf16_view = module_weight.to(torch.bfloat16).permute(2, 3, 1, 0)
    kw = c2d.kernel_weight(bf16_view)
    assert kw.is_contiguous() and kw.data_ptr() != bf16_view.data_ptr()
    assert torch.equal(kw, bf16_view)


def test_kernel_weight_pads_cout_to_8_with_zeros():
    view = t(randn(rng(31), 70, 16, 3, 3)).permute(2, 3, 1, 0)
    kw = c2d.kernel_weight(view)
    assert kw.is_contiguous() and kw.shape == (3, 3, 16, 72)
    assert torch.equal(kw[..., :70], view.to(torch.bfloat16))
    assert not kw[..., 70:].any()


def kernel_decomposition(x, w, bias):
    """The conv as csrc/conv2d_same.cu sums it, in fp32: per output tile of
    `conv_tiles`, per 64-channel chunk, a band of (rows + 2) x 66 pixels read
    from (x0 - 1, y0 - 1) with zeros outside x, flattened to one pixel axis;
    tap (dy, dx) of output row r takes its 64 pixels from (r + dy) * 66 + dx."""
    b, H, W, cin = x.shape
    cout = w.shape[3]
    rows = c2d.conv_tiles(b, H, W, cin, cout).rows
    tw, tn, ck, pitch = c2d.TILE_W, c2d.TILE_N, c2d.CHUNK, c2d.TILE_W + 2
    Hp, Wp = -(-H // rows) * rows, -(-W // tw) * tw
    cinp, coutp = -(-cin // ck) * ck, -(-cout // tn) * tn
    # zeros outside the tensor, as TMA fills them: one pixel of halo, the
    # ragged tile edges, channels past cin and outputs past cout
    xz = torch.zeros((b, Hp + 2, Wp + 2, cinp))
    xz[:, 1:H + 1, 1:W + 1, :cin] = x
    wz = torch.zeros((9, cinp, coutp))
    wz[:, :cin, :cout] = w.reshape(9, cin, cout)
    out = torch.zeros((b, Hp, Wp, coutp))
    for n0 in range(0, coutp, tn):
        for bb in range(b):
            for y0 in range(0, Hp, rows):
                for x0 in range(0, Wp, tw):
                    acc = torch.zeros((rows, tw, tn))
                    for c0 in range(0, cinp, ck):
                        # x0 - 1 .. x0 + 64 and y0 - 1 .. y0 + rows: xz is shifted by one
                        band = xz[bb, y0:y0 + rows + 2, x0:x0 + pitch, c0:c0 + ck]
                        flat = band.reshape(-1, ck)
                        for tap in range(9):
                            dy, dx = divmod(tap, 3)
                            slab = wz[tap, c0:c0 + ck, n0:n0 + tn]
                            for r in range(rows):
                                p = (r + dy) * pitch + dx
                                acc[r] += flat[p:p + tw] @ slab
                    out[bb, y0:y0 + rows, x0:x0 + tw, n0:n0 + tn] = acc
    out = out[:, :H, :W, :cout]
    return out if bias is None else out + bias


# ragged H and W against the kernel's tiles (the Pallas kernel needs H * W >= 512 at H 7)
@pytest.mark.parametrize('shape,cout', [((1, 7, 520, 48), 24), ((2, 8, 128, 128), 128)])
def test_kernel_decomposition_matches_jax(monkeypatch, shape, cout):
    monkeypatch.setattr(jc2d, '_INTERPRET', True)
    r = rng(32)
    cin = shape[-1]
    x = randn(r, *shape)
    w = randn(r, 3, 3, cin, cout, scale=(9 * cin) ** -0.5)
    bias = randn(r, cout, scale=0.1)
    mine = kernel_decomposition(t(x), t(w), t(bias))
    xla = jc2d._xla_reference(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    pallas = jc2d._forward(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), interpret=True)
    scale = max(1., float(np.abs(np.asarray(xla)).max()))
    assert max_abs(mine, xla) / scale <= TOL
    assert max_abs(mine, pallas) / scale <= TOL
    # and the port's plain version, which the CPU wrapper runs
    assert max_abs(mine, c2d.conv2d_same(t(x), t(w), t(bias))) / scale <= TOL
