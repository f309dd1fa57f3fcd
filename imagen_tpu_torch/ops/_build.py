"""Build, load and count the hand-written Hopper kernels in `csrc/`.

Every `csrc/*.cu` file (with the `csrc/*.cuh` headers it includes) is
compiled by `nvcc` for `sm_90a`, one process per file, all at once, and
linked into one shared library with a plain C interface, loaded with
`ctypes`. The build happens at first use, into `build/imagen_tpu_torch/` at
the root of the checkout, under a name keyed by a hash of the sources, so an
edit to any source rebuilds. A failed build raises; nothing falls back to
the plain PyTorch versions.

Each C entry point takes device pointers, sizes and the CUDA stream, launches
on that stream and returns `cudaGetLastError()`; `launch` raises when it is
not 0. `LAUNCHES` counts the launches of each kernel by name; `REPLAYED`
counts apart those that replays of CUDA graphs made. `plan` asks a C entry
that computes its own tiling which one it takes.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from collections import Counter
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'imagen_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-O3', '-std=c++17',
              '-Xcompiler', '-fPIC')

# The H100 as the kernels' tilings see it: its SMs (the wrappers read the
# card's own count, `sm_count`) and the shared memory a block may ask for.
SMS = 132
SMEM_LIMIT = 232448

# Launches of each kernel, by name; a wrapper adds one where it launches.
LAUNCHES: Counter = Counter()
# Launches of each kernel made by CUDA graph replays, by name: a replay adds
# the launches its capture recorded into the graph (`utils.profiling.Tape`).
REPLAYED: Counter = Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signature of each entry point; every one returns a cudaError_t.
SIGNATURES = {
    # q, k, v, q_scale (nullable), out, lse (nullable), b, rows, nk, d, scale2, stream
    'flash_rows_fwd_bf16': (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    # q, k, v, dout, lse, delta, dq, dk, dv, part (fp32 scratch), b, rows, nk, d, splits,
    # scale, stream
    'flash_rows_bwd_bf16': (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    # x, w (kh, kw, I, O), bias (nullable), out, b, H, W, cin, cout, rows, stages, grid,
    # stream
    'conv2d_same_3x3_bf16': (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, g0, w0 (hid, k), g1, w1 (k, hid), out, xn (rows, k) and h (rows, hid) scratch
    # (null but on the staged route), rows, k, hid, eps, cluster (0: the staged route),
    # stages, stream
    'fused_feedforward_bf16': (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P),
    # q, k, v, q_scale, bias2, out, P, frames, heads, nk, d, scale2, stream
    'temporal_attn_fwd_bf16': (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    # x (b, f, hw, c), g, y ((b hw), f, c), b, f, hw, c, eps, stream
    'ln_transpose_bf16': (_P, _P, _P, _I, _I, _I, _I, _F, _P),
    # out ((b hw), f, c), res (b, f, hw, c), g, y (b, f, hw, c), b, f, hw, c, eps, stream
    'norm_untranspose_bf16': (_P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    # x (b, hw, c), gamma (c,), scale, shift (nullable; rows film_stride apart), y,
    # b, hw, c, film_stride (0 without scale/shift), stream
    'fused_film_norm_bf16': (_P, _P, _P, _P, _P, _I, _I, _I, _L, _P),
    # x (rows, c), g (c,), y (rows, c), rows, c, stable, eps, stream
    'fused_layernorm_bf16': (_P, _P, _P, _I, _I, _I, _F, _P),
    # x (rows, k), g (k,), w (n, k), y (rows, n), rows, k, n, eps, stream
    'fused_ln_matmul_bf16': (_P, _P, _P, _P, _I, _I, _I, _F, _P),
    # x (rows, k), w (n, k), g (n,), y (rows, n), rows, k, n, eps, stream
    'fused_matmul_ln_bf16': (_P, _P, _P, _P, _I, _I, _I, _F, _P),
    # x (b, H, W, c), x8 (b, H, W, 8) scratch, packed w, bias (sum d), out (b, H, W, sum d),
    # the work list's sets (host int array), b, H, W, c, nscales, k0..k3, d0..d3, nsets,
    # grid, stream
    'cross_embed_stem_bf16': (_P, _P, _P, _P, _P, _P, *(_I,) * 15, _P),
    # x (b, H, W, cin), packed w, bias (nullable), out (b, cout, H, W), b, H, W, cin,
    # cout, k, stream
    'conv2d_same_cf_bf16': (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x (b, n) fp32 or bf16, scratch (b, words) int32 zeroed, out (b, 2) fp32, b, n, lo,
    # bf16, blocks a row, words, stream
    'nonneg_order_stats': (_P, _P, _P, _I, _L, _I, _I, _I, _I, _P),
}

# The tiling queries of the kernels whose C entries compute their own (kernel
# 11: ln_first, rows, k, n, sms; kernel 7: b, H, W, cin, cout, k, sms), each
# writing its ints into an array; the tests hold the Python tilings to them.
PLANS = {
    'fused_ln_matmul_plan': ((_I, _I, _I, _I, _I, _P), 8),
    'conv2d_same_cf_plan': ((_I, _I, _I, _I, _I, _I, _I, _P), 6),
}

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(CSRC.glob('*.cu'))


def source_hash():
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob('*.cu*')):  # the .cu files and the headers they include
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    candidate = Path(cuda_home) / 'bin' / 'nvcc'
    if candidate.exists():
        return str(candidate)
    raise RuntimeError('nvcc not found: the CUDA kernels cannot be built')


def _run_all(cmds):
    """Run the commands in parallel; raise with the output of the first failure."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    outputs = [proc.communicate() for proc in procs]  # waits for every process
    for cmd, proc, (out, err) in zip(cmds, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed ({proc.returncode}):\n{" ".join(cmd)}\n{out}\n{err}')


def _build(target: Path):
    """One nvcc per source, all started together, then one link."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f'{p.stem}.o') for p in _sources()]
        _run_all([[nvcc, *NVCC_FLAGS, '-c', '-o', o, str(p)]
                  for p, o in zip(_sources(), objs)])
        so = str(Path(tmp) / 'lib.so')
        _run_all([[nvcc, '-shared', '-o', so, *objs]])
        os.replace(so, target)


def library():
    """The loaded kernel library, built from the sources on first use."""
    global _lib
    with _lock:
        if _lib is None:
            target = BUILD_DIR / f'libimagen_tpu_torch_{source_hash()}.so'
            if not target.exists():
                _build(target)
            lib = ctypes.CDLL(str(target))
            for name, argtypes in (*SIGNATURES.items(),
                                   *((n, a) for n, (a, _) in PLANS.items())):
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def launch(name, *args):
    """Launch kernel `name` on the current CUDA stream; raise on a launch error."""
    import torch
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f'CUDA kernel {name} failed to launch: cudaError {err}')
    LAUNCHES[name] += 1


def plan(name, *args):
    """The tiling a C entry computes for these sizes, as a tuple of ints."""
    _, count = PLANS[name]
    out = (ctypes.c_int * count)()
    if getattr(library(), name)(*args, out) != 0:
        raise ValueError(f'{name}: no plan for {args}')
    return tuple(out)


def reset_launches():
    LAUNCHES.clear()
    REPLAYED.clear()


@functools.lru_cache(maxsize=None)
def sm_count(device_index):
    """The SMs of CUDA device `device_index`, asked of the driver once (the
    kernels' tilings size their grids by it)."""
    import torch
    return torch.cuda.get_device_properties(device_index).multi_processor_count
