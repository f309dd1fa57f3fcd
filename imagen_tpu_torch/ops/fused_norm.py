"""The fused norms of the port: kernels 10 (feedforward), 8 (ChanRMSNorm·FiLM·
SiLU), 9 (row LayerNorm) and 11 (LayerNorm->matmul, matmul->LayerNorm).

Counterparts of `imagen_tpu/ops/fused_norm.py`:

  fused_feedforward(x, g0, w0, g1, w1, eps): LayerNorm -> Linear -> exact
      GELU -> LayerNorm -> Linear, no biases (`csrc/fused_feedforward.cu`:
      the cluster kernel, tiled by `ff_tiles`, or the staged route for the
      shapes it refuses);
  fused_film_norm(x, gamma, scale, shift): silu(x / ||x|| * sqrt(C) * gamma
      * (scale + 1) + shift) over the channels of NHWC x, the prologue of a
      2-D `Block` (`csrc/fused_film_norm.cu`);
  fused_layernorm(x, g, stable, eps): the bias-free LayerNorm of
      `models.blocks.LayerNorm`, optionally divided by the row max first
      (`csrc/fused_layernorm.cu`);
  fused_ln_matmul(x, g, w, eps) and fused_matmul_ln(x, w, g, eps): a
      bias-free LayerNorm fused into the product after it, and the product
      fused into the LayerNorm after it (`csrc/fused_ln_matmul.cu`).

Each CUDA source's header says what bounds its kernel on the H100 and how
its design answers that. Weights are in the torch Linear layout (out, in),
as the modules hold them; gains are (C,). The JAX package wires kernels 9 and
11 nowhere and neither does the port: they have no site of their own.

On a CPU tensor each wrapper runs its plain PyTorch version, the JAX
package's XLA reference (`_ff_xla`, `_xla_reference`, `_ln_xla`,
`_lnmm_xla`, `_mmln_xla`). On a CUDA tensor it launches its kernel or
raises. When a gradient is wanted the call is an autograd Function whose
backward is the JAX package's: the plain version recomputed and
differentiated by autograd, so only the inputs are kept between the passes.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from imagen_tpu_torch.ops import _build
from imagen_tpu_torch.ops._build import SMEM_LIMIT, SMS
from imagen_tpu_torch.ops.tensor_utils import aligned_contiguous, wants_grad

KERNEL = 'fused_feedforward_bf16'
FILM_KERNEL = 'fused_film_norm_bf16'
LN_KERNEL = 'fused_layernorm_bf16'
LNMM_KERNEL = 'fused_ln_matmul_bf16'
MMLN_KERNEL = 'fused_matmul_ln_bf16'
_FF_WEIGHT_BUDGET = 4 * 1024 * 1024
ROW_MAX_C = 4096   # kernels 8 and 9: one warp holds a row, 16 vectors of 8 bf16 a lane
LNMM_MAX_KN = 6144  # kernel 11: 16 rows of k and of n, and the weight stages, fit in shared memory


# The tiling of csrc/fused_feedforward.cu's cluster kernel: a cluster of blocks shares FF_ROWS
# rows and splits hid; weights stream in FF_KC-column stages.
FF_ROWS, FF_KC = 64, 32
FF_WIDTHS = (128, 256, 384, 512)   # k: product 2's accumulators, k / 2 columns a warpgroup
FF_SLICES = (512, 256, 128)        # hidden columns a block holds: product 1's, 2 x its N
FF_CLUSTERS = (1, 2, 4, 8)
FF_MAX_CLUSTER = max(FF_CLUSTERS)  # the kernel's statistics buffers are sized for 8 ranks
FF_STAGED_TILE = 128               # the staged route's product tile: k and hid multiples of it
FF_MAX_STAGES = 8


class FFTiles(NamedTuple):
    cluster: int     # blocks of a cluster: one 64-row tile, hid split between them
    hid_slice: int   # hidden columns of a block, hid / cluster
    row_tiles: int
    grid: int        # blocks: row_tiles * cluster
    stages: int      # weight stages of FF_KC K-columns
    smem: int        # bytes of shared memory a block asks for


def ff_smem(k, hid_slice, stages):
    """Shared memory of a block, as csrc/fused_feedforward.cu lays it out:
    the x tile and then, in its place, the normalised hidden slice; the
    weight ring; the row statistics (partials of 8 ranks for two passes, two
    warpgroup sums); the mbarriers and 1024 bytes of alignment slack."""
    wide = max(k, hid_slice)
    return (FF_ROWS * wide * 2 + stages * wide * FF_KC * 2
            + (2 * FF_MAX_CLUSTER + 2) * FF_ROWS * 4 + 8 * (2 * stages + 1) + 1024)


@functools.lru_cache(maxsize=256)
def ff_tiles(rows, k, hid, sms=SMS):
    """The cluster kernel's tiling of one call, or None where it does not take
    (k, hid) and the staged route runs the call.

    A cluster of `cluster` blocks takes 64 rows, each block `hid_slice` =
    hid / cluster hidden columns (512, 256 or 128) and, for the reduction of the
    second product, k / cluster output columns (a multiple of 64). Of the
    splits that exist, the one that puts the most blocks to work, up to one
    per SM, then the wider slice (fewer partials to exchange); as many weight
    stages as fit, at least 3."""
    if k not in FF_WIDTHS or rows < 1:
        return None
    row_tiles = -(-rows // FF_ROWS)
    best = None
    for hs in FF_SLICES:
        cl = hid // hs
        if hid % hs or cl not in FF_CLUSTERS or k % (64 * cl):
            continue
        key = (min(row_tiles * cl, sms), hs)
        if best is None or key > best[0]:
            best = (key, hs, cl)
    if best is None:
        return None
    _, hs, cl = best
    stages = 3
    while stages < FF_MAX_STAGES and ff_smem(k, hs, stages + 1) <= SMEM_LIMIT:
        stages += 1
    # the partials of the cluster (k x 256 bytes) and the output staging fit
    # in the hidden slice's region and the ring
    wide = max(k, hs)
    if (ff_smem(k, hs, stages) > SMEM_LIMIT
            or k * 256 + FF_ROWS * (k // cl) * 2 > FF_ROWS * wide * 2 + stages * wide * FF_KC * 2):
        return None
    return FFTiles(cl, hs, row_tiles, row_tiles * cl, stages, ff_smem(k, hs, stages))


def ff_staged_takes(k, hid):
    """Whether the staged route (csrc/fused_feedforward.cu: a row LayerNorm
    and a wgmma product, twice, H through global memory) takes (k, hid); it
    runs what `ff_tiles` refuses, every shape the gate admits."""
    return k % FF_STAGED_TILE == 0 and hid % FF_STAGED_TILE == 0


def _ff_rows_block(rows, k, hid):
    for bm in (512, 256, 128, 64, 32, 16, 8):
        if rows % bm == 0 and bm * (k + hid) * 4 <= 6 * 1024 * 1024:
            return bm
    return None


def _pick_rows_block(rows, c):
    for br in (1024, 512, 256, 128, 64, 32, 16, 8):
        if rows % br == 0 and br * c * 4 <= 4 * 1024 * 1024:
            return br
    return None


def _on_cuda_takes(dtype, device_type):
    """The CUDA kernels take bf16; the CPU's plain versions take any float."""
    return device_type == 'cpu' or dtype == torch.bfloat16


def fused_feedforward_available(rows, k, hid, dtype=torch.bfloat16, device_type='cuda'):
    """The shape gate of `fused_feedforward_available` in the JAX package.

    The CUDA kernel takes bf16 only, so a CUDA tensor of another dtype stays
    on the module's unfused chain.
    """
    itemsize = torch.empty((), dtype=dtype).element_size()
    return (k % 128 == 0 and hid % 128 == 0
            and 2 * k * hid * itemsize <= _FF_WEIGHT_BUDGET
            and _ff_rows_block(rows, k, hid) is not None
            and _on_cuda_takes(dtype, device_type))


def fused_film_available(x_shape, dtype=torch.bfloat16, device_type='cuda', fuse_silu=True):
    """Whether a ChanRMSNorm call takes kernel 8, on either device.

    The JAX gate's shape conditions (`models/blocks.py:88-89`) without its
    backend check: the SiLU fused in, 4-D NHWC input, C % 128 == 0. Adds the
    kernel's own limit, C <= 4096 (the path's largest site is 3584), and,
    on CUDA, bf16. The TPU tiling fallback (rows % block_rows) changes nothing
    numerically and is dropped.
    """
    return (fuse_silu and len(x_shape) == 4 and x_shape[-1] % 128 == 0
            and x_shape[-1] <= ROW_MAX_C and _on_cuda_takes(dtype, device_type))


def fused_layernorm_available(rows, c, dtype=torch.bfloat16, device_type='cuda'):
    """`_ln_forward`'s shape conditions (c % 128 == 0 and a row block),
    plus the kernel's c <= 4096 and, on CUDA, bf16."""
    return (c % 128 == 0 and c <= ROW_MAX_C and _pick_rows_block(rows, c) is not None
            and _on_cuda_takes(dtype, device_type))


def fused_lnmm_available(rows, k, n, dtype=torch.bfloat16, device_type='cuda'):
    """`fused_lnmm_available` of the JAX package without its backend check,
    plus the kernel's shared-memory limit (k + n <= 6144) and, on CUDA, bf16."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return (k % 128 == 0 and n % 128 == 0
            and k * n * itemsize <= _FF_WEIGHT_BUDGET
            and _ff_rows_block(rows, k, n) is not None
            and k + n <= LNMM_MAX_KN and _on_cuda_takes(dtype, device_type))


# --- plain versions ---------------------------------------------------------------------

def layernorm(t, g, eps):
    """Bias-free LayerNorm of `models.blocks.LayerNorm` (stable=False)."""
    dtype = t.dtype
    tf = t.to(torch.promote_types(dtype, torch.float32))
    var = tf.var(dim=-1, unbiased=False, keepdim=True).to(dtype)
    mean = tf.mean(dim=-1, keepdim=True).to(dtype)
    return (t - mean) * torch.rsqrt(var + eps).to(dtype) * g.to(dtype)


def feedforward_reference(x, g0, w0, g1, w1, eps):
    """Plain version of kernel 3: the module chain, each product in x's dtype."""
    h = layernorm(x, g0, eps)
    h = F.linear(h, w0.to(h.dtype))
    h = F.gelu(h)
    h = layernorm(h, g1, eps)
    return F.linear(h, w1.to(h.dtype))


def film_norm_reference(x, gamma, scale=None, shift=None):
    """Plain version of kernel 8 (`_xla_reference`): fp32 math, one cast at
    the end. scale and shift hold (b, C) values (any shape that reshapes to
    it), or are both None for no FiLM."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float()
    inv = torch.rsqrt((xf * xf).sum(dim=-1, keepdim=True).clamp(min=1e-24))
    out = xf * inv * (c ** 0.5) * gamma.reshape(c).float()
    if scale is not None:
        out = out * (scale.reshape(b, 1, 1, c).float() + 1.) + shift.reshape(b, 1, 1, c).float()
    return F.silu(out).to(x.dtype)


def layernorm_reference(x, g, stable, eps):
    """Plain version of kernel 9 (`_ln_xla`): the module's LayerNorm, the
    stable variant dividing by the (detached) signed row max first."""
    if stable:
        x = x / x.amax(dim=-1, keepdim=True).detach()
    return layernorm(x, g, eps)


def ln_matmul_reference(x, g, w, eps):
    """Plain version of kernel 11's LN -> matmul (`_lnmm_xla`); w (n, k)."""
    h = layernorm(x, g, eps)
    return F.linear(h, w.to(h.dtype))


def matmul_ln_reference(x, w, g, eps):
    """Plain version of kernel 11's matmul -> LN (`_mmln_xla`): the product
    in x's dtype, then the LayerNorm; w (n, k)."""
    return layernorm(F.linear(x, w.to(x.dtype)), g, eps)


# --- forwards: the plain version on the CPU, the kernel on CUDA ---------------------------

def _check_cuda(name, x, *others):
    if not x.is_cuda or any(t is not None and t.device != x.device for t in others):
        raise ValueError(f'{name}: tensors must share one CUDA device')
    if x.dtype != torch.bfloat16:
        raise TypeError(f'{name} kernel takes bf16, got {x.dtype}')


def _gain(g, c, name):
    if g.numel() != c:
        raise ValueError(f'{name}: gain of {g.numel()} values for {c} channels')
    return aligned_contiguous(g.reshape(c).float())


def pack_ff_weights(w0, w1):
    """The weights as kernel 10 reads them: bf16 (hid, k) and (k, hid),
    contiguous, the Linears' own layout (each is K-major for its product);
    no copy for a weight that is already so."""
    return tuple(aligned_contiguous(w.to(torch.bfloat16)) for w in (w0, w1))


def _ff_forward(x, g0, w0, g1, w1, eps, packed=None):
    if x.device.type == 'cpu':
        return feedforward_reference(x, g0, w0, g1, w1, eps)
    _check_cuda('fused_feedforward', x, w0, w1)
    shape = x.shape
    k = shape[-1]
    hid = w0.shape[0]
    if tuple(w0.shape) != (hid, k) or tuple(w1.shape) != (k, hid):
        raise ValueError(f'weights {tuple(w0.shape)}, {tuple(w1.shape)} do not fit k={k}')
    rows = x.numel() // k
    if rows == 0:
        return x.new_empty(shape)
    tiles = ff_tiles(rows, k, hid, _build.sm_count(x.device.index))
    if tiles is None and not ff_staged_takes(k, hid):
        raise ValueError(f'fused_feedforward kernel takes k and hid that are multiples of '
                         f'{FF_STAGED_TILE}; got k={k}, hid={hid}')
    x2 = aligned_contiguous(x.reshape(rows, k))
    g0f, g1f = _gain(g0, k, 'fused_feedforward'), _gain(g1, hid, 'fused_feedforward')
    w0c, w1c = pack_ff_weights(w0, w1) if packed is None else packed
    out = torch.empty_like(x2)
    if tiles is None:   # the staged route: LN0(x) and H through global memory
        xn, h = torch.empty_like(x2), x2.new_empty((rows, hid))
        route = (xn.data_ptr(), h.data_ptr(), rows, k, hid, float(eps), 0, 0)
    else:
        route = (None, None, rows, k, hid, float(eps), tiles.cluster, tiles.stages)
    _build.launch(KERNEL, x2.data_ptr(), g0f.data_ptr(), w0c.data_ptr(), g1f.data_ptr(),
                  w1c.data_ptr(), out.data_ptr(), *route)
    return out.reshape(shape)


def _film_rows(t, b, c):
    """scale or shift as (b, C) bf16 rows with unit channel stride and
    16-byte aligned rows: the strided (b, 1, 1, C) halves that `chunk` gives
    are taken as they are, anything else is copied."""
    if t.dtype != torch.bfloat16:
        raise TypeError(f'fused_film_norm kernel takes bf16 scale/shift, got {t.dtype}')
    t = t.reshape(b, c)
    if t.stride(1) != 1 or t.stride(0) % 8 or t.data_ptr() % 16:
        t = aligned_contiguous(t)
    return t


def _film_forward(x, gamma, scale, shift):
    if x.device.type == 'cpu':
        return film_norm_reference(x, gamma, scale, shift)
    _check_cuda('fused_film_norm', x, gamma, scale, shift)
    if x.ndim != 4 or (scale is None) != (shift is None):
        raise ValueError(f'fused_film_norm takes (b, h, w, C) x and scale and shift together, '
                         f'got {tuple(x.shape)}')
    b, h, w, c = x.shape
    if c % 8 or c > ROW_MAX_C:
        raise ValueError(f'fused_film_norm: C {c} outside the kernel (C % 8 == 0, C <= '
                         f'{ROW_MAX_C})')
    x = aligned_contiguous(x)
    gf = _gain(gamma, c, 'fused_film_norm')
    scale_ptr = shift_ptr = None
    stride = 0
    if scale is not None:
        scale, shift = _film_rows(scale, b, c), _film_rows(shift, b, c)
        if scale.stride(0) != shift.stride(0):
            scale, shift = scale.contiguous(), shift.contiguous()
        scale_ptr, shift_ptr, stride = scale.data_ptr(), shift.data_ptr(), scale.stride(0)
    y = torch.empty_like(x)
    _build.launch(FILM_KERNEL, x.data_ptr(), gf.data_ptr(), scale_ptr, shift_ptr, y.data_ptr(),
                  b, h * w, c, stride)
    return y


def _ln_forward(x, g, stable, eps):
    if x.device.type == 'cpu':
        return layernorm_reference(x, g, stable, eps)
    _check_cuda('fused_layernorm', x, g)
    c = x.shape[-1]
    if c % 8 or c > ROW_MAX_C:
        raise ValueError(f'fused_layernorm: c {c} outside the kernel (c % 8 == 0, c <= '
                         f'{ROW_MAX_C})')
    x2 = aligned_contiguous(x.reshape(-1, c))
    gf = _gain(g, c, 'fused_layernorm')
    y = torch.empty_like(x2)
    _build.launch(LN_KERNEL, x2.data_ptr(), gf.data_ptr(), y.data_ptr(), x2.shape[0], c,
                  int(bool(stable)), float(eps))
    return y.reshape(x.shape)


def _rowblock_forward(name, x, w, g, eps):
    """Kernel 11 either way round: x (..., k), w (n, k) -> (..., n); g is
    (k,) before the product (LNMM_KERNEL) or (n,) after it (MMLN_KERNEL)."""
    ln_first = name == LNMM_KERNEL
    if x.device.type == 'cpu':
        return (ln_matmul_reference(x, g, w, eps) if ln_first else
                matmul_ln_reference(x, w, g, eps))
    _check_cuda(name, x, w, g)
    k = x.shape[-1]
    n = w.shape[0]
    if w.ndim != 2 or w.shape[1] != k:
        raise ValueError(f'{name}: weight {tuple(w.shape)} does not take k={k}')
    if k % 32 or n % 128 or k + n > LNMM_MAX_KN:
        raise ValueError(f'{name}: k={k}, n={n} outside the kernel (k % 32 == 0, '
                         f'n % 128 == 0, k + n <= {LNMM_MAX_KN})')
    x2 = aligned_contiguous(x.reshape(-1, k))
    wc = aligned_contiguous(w.to(torch.bfloat16))
    gf = _gain(g, k if ln_first else n, name)
    y = torch.empty((x2.shape[0], n), dtype=x.dtype, device=x.device)
    first, second = (gf, wc) if ln_first else (wc, gf)
    _build.launch(name, x2.data_ptr(), first.data_ptr(), second.data_ptr(), y.data_ptr(),
                  x2.shape[0], k, n, float(eps))
    return y.reshape(*x.shape[:-1], n)


# --- autograd: the JAX package's backward, the plain version differentiated ---------------

def recomputed_grads(ctx, chain, g):
    """Gradients for `ctx`'s saved tensors (None for those saved as None or
    not needed) of `chain` recomputed on them, against the output cotangent g."""
    with torch.enable_grad():
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        out = chain(*inputs)
    wanted = [t for t in inputs if t is not None and t.requires_grad]
    grads = iter(torch.autograd.grad(out, wanted, g) if wanted else ())
    return tuple(next(grads) if t is not None and t.requires_grad else None for t in inputs)


class _FusedFeedForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g0, w0, g1, w1, eps):
        ctx.save_for_backward(x, g0, w0, g1, w1)
        ctx.eps = eps
        return _ff_forward(x, g0, w0, g1, w1, eps)

    @staticmethod
    def backward(ctx, g):
        return (*recomputed_grads(
            ctx, lambda *a: feedforward_reference(*a, ctx.eps), g), None)


class _FilmNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, scale, shift):
        ctx.save_for_backward(x, gamma, scale, shift)
        return _film_forward(x, gamma, scale, shift)

    @staticmethod
    def backward(ctx, g):
        return recomputed_grads(ctx, film_norm_reference, g)


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, stable, eps):
        ctx.save_for_backward(x, g)
        ctx.stable, ctx.eps = stable, eps
        return _ln_forward(x, g, stable, eps)

    @staticmethod
    def backward(ctx, gy):
        return (*recomputed_grads(
            ctx, lambda x, g: layernorm_reference(x, g, ctx.stable, ctx.eps), gy), None, None)


class _LnMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, w, eps):
        ctx.save_for_backward(x, g, w)
        ctx.eps = eps
        return _rowblock_forward(LNMM_KERNEL, x, w, g, eps)

    @staticmethod
    def backward(ctx, gy):
        return (*recomputed_grads(
            ctx, lambda x, g, w: ln_matmul_reference(x, g, w, ctx.eps), gy), None)


class _MatmulLn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, g, eps):
        ctx.save_for_backward(x, w, g)
        ctx.eps = eps
        return _rowblock_forward(MMLN_KERNEL, x, w, g, eps)

    @staticmethod
    def backward(ctx, gy):
        return (*recomputed_grads(
            ctx, lambda x, w, g: matmul_ln_reference(x, w, g, ctx.eps), gy), None)


# --- entry points ---------------------------------------------------------------------------

def fused_feedforward(x, g0, w0, g1, w1, eps, packed=None):
    """x (..., k) -> (..., k). `packed`, where no gradient is wanted, is
    `pack_ff_weights(w0, w1)` made earlier; the kernel then reads it in place
    of casting the weights again."""
    if wants_grad(x, g0, w0, g1, w1):
        return _FusedFeedForward.apply(x, g0, w0, g1, w1, eps)
    return _ff_forward(x, g0, w0, g1, w1, eps, packed=packed)


def fused_film_norm(x, gamma, scale=None, shift=None):
    """Fused ChanRMSNorm + FiLM + SiLU. x (b, h, w, C), gamma C values,
    scale and shift (b, C) values or both None (no FiLM)."""
    if wants_grad(x, gamma, scale, shift):
        return _FilmNorm.apply(x, gamma, scale, shift)
    return _film_forward(x, gamma, scale, shift)


def fused_layernorm(x, g, stable=False, eps=1e-5):
    """Bias-free LayerNorm over the last axis (optionally ÷ the row max)."""
    if wants_grad(x, g):
        return _LayerNorm.apply(x, g, stable, eps)
    return _ln_forward(x, g, stable, eps)


def fused_ln_matmul(x, g, w, eps):
    """LayerNorm(x) @ w^T: x (..., k), g (k,), w (n, k) -> (..., n)."""
    if wants_grad(x, g, w):
        return _LnMatmul.apply(x, g, w, eps)
    return _rowblock_forward(LNMM_KERNEL, x, w, g, eps)


def fused_matmul_ln(x, w, g, eps):
    """LayerNorm(x @ w^T): x (..., k), w (n, k), g (n,) -> (..., n)."""
    if wants_grad(x, w, g):
        return _MatmulLn.apply(x, w, g, eps)
    return _rowblock_forward(MMLN_KERNEL, x, w, g, eps)
