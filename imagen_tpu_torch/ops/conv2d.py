"""Stride-1 SAME convolutions, NHWC input: kernels 6 and 7 of the TPU table.

Counterparts of `conv2d_same` and `conv2d_same_cf` in
`imagen_tpu/ops/conv2d.py`. The CUDA kernels are `csrc/conv2d_same.cu` and
`csrc/conv2d_same_cf.cu`; their headers say what bounds each on the H100 and
how its design answers that.

    conv2d_same:    x (b, H, W, cin), w (3, 3, cin, cout), bias (cout,) or None
                    -> (b, H, W, cout)
    conv2d_same_cf: x (b, H, W, cin), w (k, k, cin, cout <= 8), bias (cout,) or None
                    -> (b, cout, H, W), channel-first

On a CPU tensor each runs its plain PyTorch version (the XLA references
`_xla_reference` and `_xla_reference_cf` of the JAX package). On a CUDA
tensor it launches its kernel or raises. `SameConv3x3` calls `conv3x3`,
which decides the route (kernel 6 or cuDNN) and counts it. No module calls
`conv2d_same_cf`, as no module of the JAX package does: its gate admits no
preset's final conv, whose cin is 131 in the SR unets.

When a gradient is wanted `conv2d_same` is an autograd Function whose
backward is the JAX package's: the linear transposes of the conv in its two factors
(`imagen_tpu/ops/conv2d.py` `_bwd`, computed by XLA there, by cuDNN's
`convolution_backward` here), with no forward recompute, and the bias
gradient as the sum of the output gradient over (b, H, W). `conv2d_same_cf`'s
backward is the VJP of its plain version (`_bwd_cf`).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from imagen_tpu_torch.ops import _build
from imagen_tpu_torch.ops._build import SMEM_LIMIT, SMS
from imagen_tpu_torch.ops.fused_norm import recomputed_grads
from imagen_tpu_torch.ops.tensor_utils import wants_grad
from imagen_tpu_torch.utils.profiling import count

KERNEL = 'conv2d_same_3x3_bf16'
CF_KERNEL = 'conv2d_same_cf_bf16'
CF_MAX_COUT = 8

# The tiling of csrc/conv2d_same.cu: a tile is `rows` output rows x TILE_W
# pixels x TILE_N output channels, K in CHUNK-channel bands.
TILE_W, TILE_N, CHUNK = 64, 128, 64


class ConvTiles(NamedTuple):
    rows: int     # output rows a tile (2 or 4): 128 or 256 pixels
    stages: int   # weight stages (one tap of 64 channels x 128 outputs each)
    grid: int     # blocks; fewer than `tiles` makes the grid persistent
    tiles: int
    smem: int     # bytes of shared memory a block asks for


def conv_smem(rows, stages):
    """Shared memory of a block, as csrc/conv2d_same.cu lays it out: two
    input bands of (rows + 2) x (TILE_W + 2) pixels x 128 bytes on 1024-byte
    boundaries, the output staging (rows x 64 pixels x 256 bytes), the weight
    ring, its mbarriers and 1024 bytes of alignment slack."""
    band = -(-(rows + 2) * (TILE_W + 2) * 2 * CHUNK // 1024) * 1024
    return 2 * band + rows * TILE_W * TILE_N * 2 + stages * CHUNK * TILE_N * 2 \
        + 16 * (2 + stages) + 1024


def conv_tiles(b, H, W, cin, cout, sms=SMS):
    """The tiling of one call: 256-pixel tiles (4 rows) where they still give
    every SM a tile, else 128-pixel tiles (2 rows); as many weight stages as
    fit; and, where the tiles outnumber the SMs, a persistent grid of one
    block an SM, so a block's next tile loads during its epilogue."""
    n_tiles = -(-(-(-cout // 8) * 8) // TILE_N)

    def tiles(rows):
        return b * -(-H // rows) * -(-W // TILE_W) * n_tiles

    rows = 4 if tiles(4) >= sms else 2
    stages = 2
    while conv_smem(rows, stages + 1) <= SMEM_LIMIT:
        stages += 1
    count = tiles(rows)
    return ConvTiles(rows, stages, min(count, sms), count, conv_smem(rows, stages))


def conv2d_same_available(x_shape, w_shape, dtype=torch.bfloat16, device_type='cuda'):
    """The shape gate of `conv2d_same_available` in the JAX package.

    Its VMEM tiling condition (`_tiles_with_split`) is dropped: this kernel
    loops over cin, so every cin it admits fits. The CUDA kernel is 3x3 and
    bf16, the only conv `SameConv3x3` dispatches; a CUDA tensor of another
    dtype stays on `F.conv2d`.
    """
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    _, H, W, cin = x_shape
    kh, kw, wcin, cout = w_shape
    if kh != 3 or kw != 3 or wcin != cin:
        return False
    if cin % 128 != 0 or W % 64 != 0 or H % 8 != 0:
        return False
    dtype_ok = device_type == 'cpu' or dtype == torch.bfloat16
    if 128 * 128 <= H * W <= 1024 * 1024 and cout >= 128:
        return dtype_ok
    return dtype_ok and H * W == 64 * 64 and cin >= 1024 and cout >= 128


def conv2d_same_reference(x, w, bias):
    """Plain version: the conv in x's dtype, then the bias added."""
    k = w.shape[0]
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 padding=k // 2).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def kernel_weight(w):
    """The (3, 3, cin, coutp) bf16 weight the kernel reads, coutp = cout
    rounded up to 8 (TMA rows are 16-byte multiples), zero past cout: at most
    one copy (none for a contiguous bf16 weight of cout % 8 == 0), whatever
    the strides of `w` (`SameConv3x3` hands over a permuted view)."""
    cout = w.shape[3]
    coutp = -(-cout // 8) * 8
    if coutp == cout and w.dtype == torch.bfloat16 and w.is_contiguous():
        return w
    wp = torch.empty((*w.shape[:3], coutp), dtype=torch.bfloat16, device=w.device)
    wp[..., :cout].copy_(w)
    wp[..., cout:].zero_()
    return wp


def _conv_forward(x, w, bias):
    if x.device.type == 'cpu':
        return conv2d_same_reference(x, w, bias)
    if not x.is_cuda or w.device != x.device:
        raise ValueError('conv2d_same: x and w must share one CUDA device')
    if x.dtype != torch.bfloat16:
        raise TypeError(f'conv2d_same kernel takes bf16, got {x.dtype}')
    b, H, W, cin = x.shape
    if tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f'weight {tuple(w.shape)} does not fit input {tuple(x.shape)}')
    if cin % 16 != 0:
        raise ValueError(f'conv2d_same kernel needs cin % 16 == 0, got {cin}')
    cout = w.shape[3]
    x = x.contiguous()
    w = kernel_weight(w)
    coutp = w.shape[3]
    if bias is not None:
        bias = F.pad(bias.to(torch.bfloat16), (0, coutp - cout)).contiguous()
    out = torch.empty((b, H, W, coutp), dtype=x.dtype, device=x.device)
    tiles = conv_tiles(b, H, W, cin, coutp, _build.sm_count(x.device.index))
    _build.launch(KERNEL, x.data_ptr(), w.data_ptr(),
                  None if bias is None else bias.data_ptr(), out.data_ptr(),
                  b, H, W, cin, coutp, tiles.rows, tiles.stages, tiles.grid)
    return out if coutp == cout else out[..., :cout]


class _Conv2dSame(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        ctx.bias_dtype = None if bias is None else bias.dtype
        return _conv_forward(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        # the unpadded weight, in x's dtype as the forward used it
        wc = w.to(x.dtype).permute(3, 2, 0, 1)
        dx, dw, _ = torch.ops.aten.convolution_backward(
            g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), wc, None, [1, 1], [1, 1],
            [1, 1], False, [0, 0], 1, [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        if dx is not None:
            dx = dx.permute(0, 2, 3, 1)
        if dw is not None:
            dw = dw.permute(2, 3, 1, 0).to(w.dtype)
        db = None
        if ctx.bias_dtype is not None and ctx.needs_input_grad[2]:
            db = g.sum(dim=(0, 1, 2)).to(ctx.bias_dtype)
        return dx, dw, db


def conv2d_same(x, w, bias):
    """x NHWC, w (3, 3, cin, cout), bias (cout,) or None."""
    if wants_grad(x, w, bias):
        return _Conv2dSame.apply(x, w, bias)
    return _conv_forward(x, w, bias)


def conv3x3(x, w, bias, plain):
    """A `models.blocks.SameConv3x3` call, w (cout, cin, 3, 3): kernel 6 where
    the gate admits it, else `plain()` (cuDNN); counted under `conv3x3`,
    keyed (b, H, W, cin, cout), with 18 b H W cin cout operations."""
    b, H, W, _ = x.shape
    cout, cin = w.shape[:2]
    kernel = conv2d_same_available(tuple(x.shape), (3, 3, cin, cout), x.dtype, x.device.type)
    count('conv3x3', 'kernel' if kernel else 'cudnn', (b, H, W, cin, cout),
          18 * b * H * W * cin * cout)
    if kernel:
        return conv2d_same(x, w.to(x.dtype).permute(2, 3, 1, 0), bias)
    return plain()


# --- kernel 7: tiny cout, channel-first output --------------------------------------------

def conv2d_same_cf_available(x_shape, w_shape, dtype=torch.bfloat16, device_type='cuda'):
    """The shape gate of `conv2d_same_cf_available` in the JAX package: odd
    square kernels, cin % 128 == 0, W % 128 == 0, H % 8 == 0, cout <= 8,
    H * W >= 256^2. Its backend, environment and VMEM (`_pick_blocks_cf`)
    conditions are dropped (the kernel streams cin); on CUDA it takes bf16."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    _, H, W, cin = x_shape
    kh, kw, wcin, cout = w_shape
    if kh != kw or kh % 2 == 0 or wcin != cin:
        return False
    if cin % 128 != 0 or W % 128 != 0 or H % 8 != 0:
        return False
    if cout > CF_MAX_COUT or H * W < 256 * 256:
        return False
    return device_type == 'cpu' or dtype == torch.bfloat16


def conv2d_same_cf_reference(x, w, bias):
    """Plain version (`_xla_reference_cf`): the NHWC conv, channels moved first."""
    return conv2d_same_reference(x, w, bias).permute(0, 3, 1, 2)


# The plan of csrc/conv2d_same_cf.cu (`plan` there computes the same; the C
# entry takes none): strips of 128 output columns at most, 16 a pair of warps;
# k up to 19; weight rows of CF_WKP values (16 channels and 8 of padding).
CF_MAX_K, CF_WKP = 19, 24
CF_SM_SMEM = 233472   # shared memory of an SM
CF_MIN_RUN = 16       # strip-rows a block at least, where there are that many


class CfPlan(NamedTuple):
    strip_w: int    # output columns of a strip: 16 a pair of warps
    chunks: int     # 16-channel chunks of a window group (all of cin, but without the ring)
    staging: int    # rows in flight in the ring of bulk copies; 0: read straight from x
    wsmem: bool     # the weights held in shared memory (else read through L1)
    grid: int       # blocks, each one contiguous run of the strip-rows
    smem: int       # bytes of shared memory a block asks for


def cf_smem(sw, chunks, staging, wsmem, cin, k):
    """Shared memory of a block, as csrc/conv2d_same_cf.cu lays it out: the
    window of sw + 2p pixels x an odd number of 16-byte chunks, the staging
    slots of one raw row segment each (16-byte multiples with 32 bytes of
    slack), the weights where held, the output row (8 channels x sw), the
    second warp of each tile's fp32 sums (512 bytes a 16-column tile) and the
    mbarriers."""
    pix, ch16 = sw + 2 * (k // 2), -(-cin // 16)
    slot = (pix * cin * 2 + 32 + 15) // 16 * 16
    weights = k * k * ch16 * CF_MAX_COUT * CF_WKP * 2 if wsmem else 0
    return (pix * (2 * chunks + 1) * 16 + staging * slot + weights + CF_MAX_COUT * sw * 2
            + sw // 16 * 512 + 8 * staging)


@functools.lru_cache(maxsize=256)
def cf_plan(b, H, W, cin, k, sms=SMS):
    """The widest strip (128, 64, 32, 16 columns) whose window of all of
    cin, ring of 3 (else 2) staging rows and output row fit in shared memory,
    with the weights where they fit too; failing all, 16-column strips
    without the ring, as many channel chunks a window group as fit. Then one
    block for each run of at least CF_MIN_RUN strip-rows, at most as many as
    the SMs hold at once."""
    ch16 = -(-cin // 16)
    plan = None
    for sw in (128, 64, 32, 16):
        for staging in (3, 2):
            for wsmem in (True, False):
                if plan is None and cf_smem(sw, ch16, staging, wsmem, cin, k) <= SMEM_LIMIT:
                    plan = (sw, ch16, staging, wsmem)
    if plan is None:
        wsmem = cf_smem(16, 1, 0, True, cin, k) <= SMEM_LIMIT
        chunks = 1
        while chunks < ch16 and cf_smem(16, chunks + 1, 0, wsmem, cin, k) <= SMEM_LIMIT:
            chunks += 1
        plan = (16, chunks, 0, wsmem)
    smem = cf_smem(*plan, cin, k)
    per_sm = max(1, min(CF_SM_SMEM // (smem + 1024), 64 // (plan[0] // 8)))
    rows = b * -(-W // plan[0]) * H
    return CfPlan(*plan, max(1, min(rows // CF_MIN_RUN, sms * per_sm)), smem)


def _packed_cf_weights(w):
    """(k, k, cin, cout) as (k * k, ceil(cin / 16), 8, 24) bf16: per tap and
    16-channel chunk, each output's 16 channels and 8 zeros (48-byte rows,
    conflict-free fragment loads), zero past cin and cout."""
    k, _, cin, cout = w.shape
    cinp = -(-cin // 16) * 16
    wp = F.pad(w.to(torch.bfloat16), (0, CF_MAX_COUT - cout, 0, cinp - cin))
    wp = wp.reshape(k * k, cinp // 16, 16, CF_MAX_COUT).permute(0, 1, 3, 2)
    return F.pad(wp, (0, CF_WKP - 16)).contiguous()


def _cf_forward(x, w, bias):
    if x.device.type == 'cpu':
        return conv2d_same_cf_reference(x, w, bias)
    if not x.is_cuda or w.device != x.device or (bias is not None and bias.device != x.device):
        raise ValueError('conv2d_same_cf: tensors must share one CUDA device')
    if x.dtype != torch.bfloat16:
        raise TypeError(f'conv2d_same_cf kernel takes bf16, got {x.dtype}')
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f'conv2d_same_cf takes 4-D x and w, got {tuple(x.shape)}, '
                         f'{tuple(w.shape)}')
    b, H, W, cin = x.shape
    k, kw, wcin, cout = w.shape
    if kw != k or k % 2 == 0 or k > CF_MAX_K or wcin != cin or not 1 <= cout <= CF_MAX_COUT:
        raise ValueError(f'conv2d_same_cf kernel takes an odd square (k, k, cin, cout <= 8) '
                         f'weight, k <= {CF_MAX_K}; got {tuple(w.shape)} for input '
                         f'{tuple(x.shape)}')
    x = x.contiguous()
    wp = _packed_cf_weights(w)
    if bias is not None:
        bias = bias.to(torch.bfloat16).contiguous()
    out = torch.empty((b, cout, H, W), dtype=x.dtype, device=x.device)
    _build.launch(CF_KERNEL, x.data_ptr(), wp.data_ptr(),
                  None if bias is None else bias.data_ptr(), out.data_ptr(),
                  b, H, W, cin, cout, k)
    return out


class _Conv2dSameCf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w, bias)
        return _cf_forward(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        return recomputed_grads(ctx, conv2d_same_cf_reference, g)


def conv2d_same_cf(x, w, bias):
    """x NHWC (b, H, W, cin), w (k, k, cin, cout <= 8), bias (cout,) or None
    -> (b, cout, H, W)."""
    if wants_grad(x, w, bias):
        return _Conv2dSameCf.apply(x, w, bias)
    return _cf_forward(x, w, bias)
