"""The CrossEmbed stem in one pass: kernel 14 of the port.

Counterpart of `cross_embed_stem` in `imagen_tpu/ops/stem_conv.py`: every
scale of a stride-1 `CrossEmbedLayer` (a SAME conv per kernel size, the
channels split between the scales), concatenated, plus the bias.

    x (b, H, W, c), ws [(k_i, k_i, c, d_i)], bias (sum d_i,) -> (b, H, W, sum d_i)

The CUDA kernel is `csrc/cross_embed_stem.cu`; its header says what bounds
it on the H100 and how its design answers that. The TPU kernel's 4x4
space-to-depth copy of the input existed to feed the MXU and is not carried
over.

On a CPU tensor `cross_embed_stem` runs `cross_embed_stem_reference`, the
plain version (the JAX package's `_xla_reference`). On a CUDA tensor it
launches the kernel or raises. When a gradient is wanted the call is an
autograd Function whose backward is the JAX package's `_bwd`: the VJP of
the plain version, recomputed from the saved inputs. `CrossEmbedLayer`
calls `cross_embed`, which decides each call's route.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from imagen_tpu_torch.ops import _build
from imagen_tpu_torch.ops._build import SMEM_LIMIT, SMS
from imagen_tpu_torch.ops.fused_norm import recomputed_grads
from imagen_tpu_torch.ops.tensor_utils import aligned_contiguous, wants_grad

KERNEL = 'cross_embed_stem_bf16'
MAX_SCALES = 4      # the C entry point takes up to four (k, d) pairs
MAX_KERNEL = 15     # the input band's halo is sized for p <= 7

# The tiling of csrc/cross_embed_stem.cu: a tile is STEM_ROWS output rows x
# STEM_TW pixels of one weight set (a scale's channel chunk of n channels).
STEM_ROWS, STEM_TW = 8, 64
STEM_BAND = 28672   # bytes of one input band stage: (8 + 14) rows x 80 pixels x 16, to 1024
STEM_NS = (16, 32, 64, 128)   # a set's channels, the wgmma N
STEM_MAX_SETS = 32
# shared memory for a set's weights: what two bands, 6 mbarriers, the sets'
# table (32 x 7 ints) and the 1024-byte alignment slack leave
STEM_OVERHEAD = 48 + STEM_MAX_SETS * 28 + 1024
STEM_WEIGHT_BUDGET = SMEM_LIMIT - 2 * STEM_BAND - STEM_OVERHEAD


class StemSet(NamedTuple):
    scale: int   # index into ws
    k: int
    d: int       # the scale's channels
    coff: int    # its first output channel
    n0: int      # the set's first channel of the scale
    n: int       # the set's channels (wgmma N; those past d are not stored)
    woff: int    # its first element in the packed weights


class StemPlan(NamedTuple):
    sets: tuple   # StemSet, the work list's order
    tiles: int    # tiles of one set: b x ceil(H / 8) x ceil(W / 64)
    items: int    # sets x tiles
    grid: int     # blocks: one an SM, persistent
    smem: int     # bytes of shared memory a block asks for


def stem_tap_pairs(k):
    """Tap pairs of a row of k taps, one k16 step each, rounded up to 2, 4 or 8
    (the kernel's instances; pairs past the taps have zero weights)."""
    pairs = (k + 1) // 2
    return 2 if pairs <= 2 else 4 if pairs <= 4 else 8


def stem_stacked_rows(n):
    """Output rows a wgmma stacks along N for a set of n channels (N = 64 or 128)."""
    return min(STEM_ROWS // 2, 128 // n)


def stem_weight_bytes(k, n):
    """Shared memory of one set's weights: 2P tap columns (P tap pairs), each
    k blocks of (n, 8) bf16, with stacked rows - 1 zero blocks before,
    between and after them."""
    columns, pad = 2 * stem_tap_pairs(k), stem_stacked_rows(n) - 1
    return (columns * k + (columns + 1) * pad) * n * 16


def stem_sets(ks, ds):
    """The weight sets, largest kernel first (the 15 x 15 scale's tiles lead
    the work list, the cheap 3 x 3 ones fill its end), each scale's channels
    in as few chunks as the registers and the weight budget allow: n is the
    power of two (16 to 128) that covers d, halved while the set would not
    fit."""
    coffs = [sum(ds[:i]) for i in range(len(ds))]
    sets, woff = [], 0
    for s in sorted(range(len(ks)), key=lambda i: -ks[i]):
        k, d = ks[s], ds[s]
        n = next((n for n in STEM_NS if n >= d), STEM_NS[-1])
        while n > STEM_NS[0] and stem_weight_bytes(k, n) > STEM_WEIGHT_BUDGET:
            n //= 2
        for n0 in range(0, d, n):
            sets.append(StemSet(s, k, d, coffs[s], n0, n, woff))
            woff += stem_weight_bytes(k, n) // 2
    return tuple(sets)


@functools.lru_cache(maxsize=256)
def stem_plan(b, H, W, ks, ds, sms=SMS):
    """The work list of one call: every set's tiles, set by set, walked by a
    persistent grid of at most one block an SM."""
    sets = stem_sets(ks, ds)
    tiles = b * -(-H // STEM_ROWS) * -(-W // STEM_TW)
    items = len(sets) * tiles
    smem = 2 * STEM_BAND + max(stem_weight_bytes(st.k, st.n) for st in sets) + STEM_OVERHEAD
    return StemPlan(sets, tiles, items, min(items, sms), smem)


def stem_available(x_shape, kernel_sizes, dtype=torch.bfloat16, device_type='cuda'):
    """The shape gate of `stem_available` in the JAX package: NHWC, c * 16
    <= 128, H and W divisible by 4, odd kernels. Its backend, environment
    and row-band (`_pick_hb`) conditions are dropped; the kernel's own
    limits are added (at most 4 scales, kernels up to 15), and on CUDA the
    kernel takes bf16."""
    if len(x_shape) != 4:
        return False
    _, H, W, c = x_shape
    if c * 16 > 128 or H % 4 or W % 4:
        return False
    if any(k % 2 == 0 for k in kernel_sizes):
        return False
    if not 1 <= len(kernel_sizes) <= MAX_SCALES or max(kernel_sizes) > MAX_KERNEL:
        return False
    return device_type == 'cpu' or dtype == torch.bfloat16


def cross_embed_stem_reference(x, ws, bias):
    """Plain version (`_xla_reference`): a stride-1 SAME conv per scale in x's
    dtype, concatenated, then the bias added."""
    xc = x.permute(0, 3, 1, 2)
    ys = [F.conv2d(xc, w.to(x.dtype).permute(3, 2, 0, 1), padding=w.shape[0] // 2)
          for w in ws]
    y = torch.cat(ys, dim=1).permute(0, 2, 3, 1)
    return y + bias.to(y.dtype)


@functools.lru_cache(maxsize=256)
def _set_table(sets):
    """The sets as the C entry reads them: 7 ints a set, host memory kept
    with the (cached) plan."""
    return (ctypes.c_int * (7 * len(sets)))(*(v for st in sets for v in st))


def pack_stem_weights(ws):
    """The scales' (k, k, c, d) weights as the kernel reads them, set by set in
    `stem_sets` order. A set is 2P tap columns dx (P = `stem_tap_pairs(k)`),
    each k blocks of (n, 8) bf16, the B operand's rows for one K half of a k16
    step: block i is tap (k - 1 - i, dx), its n output channels x 8 input
    channels. Before, between and after the columns lie
    `stem_stacked_rows(n) - 1` zero blocks. Columns past k, channels past c
    and outputs past d are zero."""
    ks, ds = [w.shape[0] for w in ws], [w.shape[3] for w in ws]
    packed = []
    for st in stem_sets(ks, ds):
        w = ws[st.scale]
        k, _, c, d = w.shape
        pad = stem_stacked_rows(st.n) - 1
        dp = max(d, st.n0 + st.n)
        wp = F.pad(w.to(torch.bfloat16), (0, dp - d, 0, 8 - c, 0, 2 * stem_tap_pairs(k) - k))
        wp = wp[..., st.n0:st.n0 + st.n]
        wp = wp.flip(0).permute(1, 0, 3, 2)                  # (dx, k - 1 - dy, n, 8)
        wp = F.pad(wp, (0, 0, 0, 0, 0, pad))                 # zero blocks after each column
        packed.append(F.pad(wp.reshape(-1), (pad * st.n * 8, 0)))   # and before the first
    return torch.cat(packed).contiguous()


def _stem_forward(x, bias, *ws, packed=None):
    if x.device.type == 'cpu':
        return cross_embed_stem_reference(x, ws, bias)
    if not x.is_cuda or bias.device != x.device or any(w.device != x.device for w in ws):
        raise ValueError('cross_embed_stem: tensors must share one CUDA device')
    if x.dtype != torch.bfloat16:
        raise TypeError(f'cross_embed_stem kernel takes bf16, got {x.dtype}')
    if x.ndim != 4 or x.shape[-1] > 8:
        raise ValueError(f'cross_embed_stem takes (b, H, W, c <= 8), got {tuple(x.shape)}')
    b, H, W, c = x.shape
    ks = [w.shape[0] for w in ws]
    if not 1 <= len(ws) <= MAX_SCALES or any(
            w.ndim != 4 or w.shape[1] != w.shape[0] or w.shape[2] != c for w in ws):
        raise ValueError(f'cross_embed_stem: weights {[tuple(w.shape) for w in ws]} do not '
                         f'fit input {tuple(x.shape)}')
    if any(k % 2 == 0 or k > MAX_KERNEL for k in ks):
        raise ValueError(f'cross_embed_stem kernel takes odd kernels up to {MAX_KERNEL}, '
                         f'got {ks}')
    ds = [w.shape[3] for w in ws]
    if tuple(bias.shape) != (sum(ds),):
        raise ValueError(f'cross_embed_stem: bias {tuple(bias.shape)}, expected ({sum(ds)},)')
    plan = stem_plan(b, H, W, tuple(ks), tuple(ds), _build.sm_count(x.device.index))
    if len(plan.sets) > STEM_MAX_SETS:
        raise ValueError(f'cross_embed_stem: {len(plan.sets)} weight sets, the kernel takes '
                         f'{STEM_MAX_SETS}')
    out = torch.empty((b, H, W, sum(ds)), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    x = aligned_contiguous(x)
    x8 = x if c == 8 else torch.empty((b, H, W, 8), dtype=x.dtype, device=x.device)
    w = pack_stem_weights(ws) if packed is None else packed
    bias = aligned_contiguous(bias.to(torch.bfloat16))
    pad = MAX_SCALES - len(ws)
    table = ctypes.addressof(_set_table(plan.sets))
    _build.launch(KERNEL, x.data_ptr(), x8.data_ptr(), w.data_ptr(), bias.data_ptr(),
                  out.data_ptr(), table, b, H, W, c, len(ws), *ks, *([0] * pad), *ds,
                  *([0] * pad), len(plan.sets), plan.grid)
    return out


class _CrossEmbedStem(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias, *ws):
        ctx.save_for_backward(x, bias, *ws)
        return _stem_forward(x, bias, *ws)

    @staticmethod
    def backward(ctx, g):
        return recomputed_grads(
            ctx, lambda x, bias, *ws: cross_embed_stem_reference(x, ws, bias), g)


def cross_embed_stem(x, ws, bias, packed=None):
    """x NHWC (c <= 8); ws the scales' (k, k, c, d_i) weights, sorted like
    `CrossEmbedLayer`'s; bias (sum d_i,). `packed`, where no gradient is
    wanted, is `pack_stem_weights(ws)` made earlier; the kernel then reads it
    in place of packing ws again."""
    if wants_grad(x, bias, *ws):
        return _CrossEmbedStem.apply(x, bias, *ws)
    return _stem_forward(x, bias, *ws, packed=packed)


def cross_embed(x, kernel_sizes, dtype, stride, params, weights, kept, plain):
    """A `models.blocks.CrossEmbedLayer` call: kernel 14 where the stride is 1
    and the gate admits x, on `weights()` (ws, bias) while a gradient is wanted
    over x and `params`, else on `kept()` (ws, bias, packed); else `plain()`."""
    if stride != 1 or not stem_available(tuple(x.shape), kernel_sizes, dtype, x.device.type):
        return plain()
    x = x.to(dtype)
    if wants_grad(x, *params):
        return cross_embed_stem(x, *weights())
    return cross_embed_stem(x, *kept())
