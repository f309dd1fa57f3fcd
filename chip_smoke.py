#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Drives imagen_tpu_torch's paths at full width, with bf16 compute over fp32
parameters and random weights from a seed:
- serving: BaseUnet64 -> SRUnet256, an `ImagenServer` that warms up and
  answers three requests;
- training: `ImagenTrainer.step_with_batch` for 3 steps of each of the two
  configurations the JAX bench trains, unet 1 (BaseUnet64 alone, batch 8)
  and unet 2 (NullUnet + SRUnet256 with the low-res conditioning loss,
  batch 4), with Adam, clipping and EMA;
- video: the `Unet3D` of the JAX bench's video mode (dim 64, mults 1-2-4,
  16 frames at 64 px), an `ImagenServer(video_frames=16)` that warms up and
  answers three requests of one prompt;
- video training: the same `Unet3D` with its fused temporal norms on
  (`temporal_fused_ln=True`, so kernels 12 and 13 lie on the path),
  `ImagenTrainer.step_with_batch` for 3 steps on batch 4 clips of 16 frames
  at 64 px, with Adam, clipping and EMA;
- EDM serving: `ElucidatedImagen` over BaseUnet64 -> SRUnet256 built with
  `fused_film=True` (kernel 8 at every 2-D Block), the churn + Heun sampler
  at 16 + 8 steps (31 + 15 forwards), an `ImagenServer` that warms up and
  answers three requests; kernel 8's launches are checked against forward
  hooks that count the fused norm calls; the same hooks record the shapes
  of the LayerNorm and attention-projection sites, where kernels 9 and 11
  (wired nowhere, as in the JAX package) would run; then three requests
  each with kernel 8 on and off on the same weights, in turns, and two
  each with kernel 14 on and off (its gate closed);
- SR-1024 serving: the JAX bench's `sr1024_paper` (BASELINE config 4),
  `NullUnet` + `SRUnet1024` at 256 -> 1024, `Imagen.sample` from `start_at_unet_number=2`
  with a seeded 256 px start image, batch 1 (2 with CFG), cond_scale 3,
  SR_STEPS steps; one warm-up, then three requests (kernels 14, 6, the
  flash forward at `mid_attn` and the feedforward in the Perceiver lie on
  the path); kernel 14's launches
  are checked against forward hooks on `CrossEmbedLayer`, kernel 6's
  against hooks on the `SameConv3x3` sites its gate admits; a hook records
  the final conv's input, where kernel 7 (wired nowhere, as in the JAX
  package) would run; the device FLOPs of one forward from
  `torch.utils.flop_counter`; then two request pairs with kernel 14 on and
  off (its gate closed) on the same weights, in turns; then one request
  each with kernel 6 on and off (its gate closed, so cuDNN runs those
  convs) under torch.profiler, for the device time of the request and of
  kernel 6 in it.
Every path's cross-embed stem runs kernel 14: its gate admits the stem of
every U-Net above.
The launch counts are set to 0 just before each path and read just after.
Then it holds each hand-written kernel, at every shape the paths launched
it at (kernels 9, 11 and 7 at every recorded site shape; kernel 7 also at
the (2, 1024, 1024, 128) -> 3 shape that the JAX gate admits, and kernel
10 at the Perceiver's batch 2 and 4 and on its staged route at (8192, 384,
768) and (288, 1024, 1024), logged and weighted by nothing), against its plain
PyTorch version, and a small bf16 U-Net and a small bf16 Unet3D that reach
every kernel of the paths against the same nets on the plain path, outputs
and gradients, both measured against fp32.

Prints, in order: the card (nvidia-smi name and power limit) and CUDA
version; the kernel build time; per request latency, shape, finiteness and
range; per training step loss, time and peak memory; launch counts per path;
per video request latency, shape, finiteness, range and peak memory; per
video training step loss, time and peak memory; per EDM request latency,
shape, finiteness, range and peak memory, kernel 8's sites per forward, the
sites of kernels 9 and 11, the on/off latencies and output difference;
per SR-1024 request latency, shape, finiteness, range and peak memory, the
forward's FLOPs, kernel 14's and kernel 6's launches against their hook
counts, kernel 7's site, the on/off latencies and output difference, the
profiled requests' device time and kernel 6's share of it; the device time
of the wrapper's weight copy at the (3, 3, 2048, 1024) site;
per-kernel errors, CUDA-event times, device times and bounds at each shape
(with the unfused route's time and device time for kernels 8, 10, 11, 12, 13
and 14, and its factor over the kernel's device time; kernels 10 and 14 also
held to the same bits on a second call); the small nets' errors; then the card again, one JSON line of kernel results and, last,
the result line {"ok": ..., "device": {...}}.

In the kernel line, `launches` is the sum over the paths (split in
`launches_by_path`); `ms`, `plain_ms`, `library_ms` and `bound_ms` are per-call
times at each launched shape times that shape's launches in the paths,
summed (for kernels 9, 11 and 7, `on_path` false, times that shape's site
count, `sites`, keyed by the path that recorded them, since they launch
nowhere on a path). `bound_ms` is the
least time the H100 could take for that work, the
larger of its operations at the dense bf16 peak and its bytes (each input
read once, each output written once) at the HBM rate; `bound_by` says which of
the two bounds most of it. `library_ms` times one PyTorch call that computes
the same function (`F.scaled_dot_product_attention`, its backward,
`F.conv2d`, `F.layer_norm` for kernel 9 without the stable division; for
the temporal kernel SDPA on the pre-normalised q and k, K and V expanded
over the heads, with the bias table as `attn_mask`; for kernel 7
`F.conv2d` on the NHWC view, whose result is the channel-first output),
null where there is none (the feedforward; kernels 8 and 11, for which no
one call fuses the norm with the FiLM and SiLU or with the product;
kernels 12 and 13: no one call fuses a LayerNorm with a relayout; kernel
14: no one call runs convs of three kernel sizes). For kernels 8, 10, 11,
12, 13 and 14 `unfused_route_ms` times the port's unfused module chain
instead, and `unfused_route_device_ms` every device kernel it launches (for
10 the `FeedForward` module with its gate closed: LayerNorm, the fp32 weight
cast and `F.linear` on cuBLAS, exact GELU, LayerNorm, the cast and
`F.linear`; for 11 that chain is its plain version; for 14 three cuDNN convs
and the `cat`). For every kernel `device_ms` sums the device time per call
that torch.profiler reads at each shape, weighted the same way: for the flash
backward, its three CUDA functions (the dK/dV pass, the sum of its row
slices, dQ); for the stem, its copy of the input padded to 8 channels and
the stem. For those with a library call, `library_device_ms` sums every
device kernel that call launches, weighted the same way (the flash
forward's SDPA takes q and k normalised beforehand). `max_abs_err` is the
kernel's worst error against the fp32 truth over those shapes and outputs.

Exits non-zero if any phase fails. Needs a GPU and the imagen_tpu_torch
package beside this file; imports no JAX.
"""
import gc
import json
import math
import subprocess
import sys
import time
import traceback
from collections import Counter, defaultdict
from contextlib import contextmanager
from pathlib import Path

REPO = Path(__file__).resolve().parent
TIMESTEPS = (16, 8)          # serving steps, cut for the run's time; widths are not cut
EDM_STEPS = (16, 8)          # EDM steps, cut from edm_paper's (64, 32) for the run's time
VIDEO_STEPS = 16             # video steps, cut from the JAX bench's 32 for time
VIDEO_FRAMES = 16
VIDEO_TEMPORAL_SITES = 8     # TemporalAttention sites per Unet3D forward
REQUEST_SIZES = (4, 2, 3)
TRAIN_STEPS = 3
TRAIN_CONFIGS = ((1, 8), (2, 4))   # (unet number, batch), as the JAX bench trains them
VIDEO_TRAIN_BATCH = 4
SR_STEPS = 8                 # SR-1024 steps, cut from the JAX bench's 32 (sr1024_paper) for time
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
PEAK_HBM_BYTES = 3.35e12     # H100 SXM HBM3 bytes per second
# `device_kernel`: the name (or a prefix shared by every CUDA function one
# call launches) for device times from the profiler
KERNEL_INFO = {
    'flash_rows_fwd_bf16': dict(
        source='imagen_tpu_torch/csrc/flash_rows_fwd.cu',
        replaces='imagen_tpu/ops/flash_attention.py:249', device_kernel='flash_rows_fwd_kernel'),
    # `device_kernels`: how many CUDA functions a call launches, if not 1:
    # here the dK/dV pass, the sum of its row slices and dQ
    'flash_rows_bwd_bf16': dict(
        source='imagen_tpu_torch/csrc/flash_rows_bwd.cu',
        replaces='imagen_tpu/ops/flash_attention.py:591', device_kernel='flash_rows_bwd_',
        device_kernels=3),
    'conv2d_same_3x3_bf16': dict(
        source='imagen_tpu_torch/csrc/conv2d_same.cu',
        replaces='imagen_tpu/ops/conv2d.py:199', device_kernel='conv2d_same_3x3_kernel'),
    'fused_feedforward_bf16': dict(
        source='imagen_tpu_torch/csrc/fused_feedforward.cu',
        replaces='imagen_tpu/ops/fused_norm.py:271', device_kernel='fused_feedforward_'),
    'temporal_attn_fwd_bf16': dict(
        source='imagen_tpu_torch/csrc/temporal_attn_fwd.cu',
        replaces='imagen_tpu/ops/flash_attention.py:886', device_kernel='temporal_attn_fwd_kernel'),
    # kernels 12 and 13 are one CUDA function, its fold and unfold variants
    'ln_transpose_bf16': dict(
        source='imagen_tpu_torch/csrc/temporal_layout.cu',
        replaces='imagen_tpu/ops/temporal_layout.py:136', device_kernel='ln_relayout_kernel'),
    'norm_untranspose_bf16': dict(
        source='imagen_tpu_torch/csrc/temporal_layout.cu',
        replaces='imagen_tpu/ops/temporal_layout.py:184', device_kernel='ln_relayout_kernel'),
    'fused_film_norm_bf16': dict(
        source='imagen_tpu_torch/csrc/fused_film_norm.cu',
        replaces='imagen_tpu/ops/fused_norm.py:63', device_kernel='film_norm_kernel'),
    'fused_layernorm_bf16': dict(
        source='imagen_tpu_torch/csrc/fused_layernorm.cu',
        replaces='imagen_tpu/ops/fused_norm.py:155', device_kernel='layernorm_rows_kernel'),
    'fused_ln_matmul_bf16': dict(
        source='imagen_tpu_torch/csrc/fused_ln_matmul.cu',
        replaces='imagen_tpu/ops/fused_norm.py:384', device_kernel='ln_matmul_kernel'),
    'fused_matmul_ln_bf16': dict(
        source='imagen_tpu_torch/csrc/fused_ln_matmul.cu',
        replaces='imagen_tpu/ops/fused_norm.py:384', device_kernel='matmul_ln_kernel'),
    # the input's 8-channel copy and the stem itself (one launch of each a call)
    'cross_embed_stem_bf16': dict(
        source='imagen_tpu_torch/csrc/cross_embed_stem.cu',
        replaces='imagen_tpu/ops/stem_conv.py:201', device_kernel='cross_embed_',
        device_kernels=2),
    'conv2d_same_cf_bf16': dict(
        source='imagen_tpu_torch/csrc/conv2d_same_cf.cu',
        replaces='imagen_tpu/ops/conv2d.py:403', device_kernel='conv2d_same_cf_kernel'),
}
STEM_KERNEL = 'cross_embed_stem_bf16'   # every path's stem: its gate admits them all
IMAGE_KERNELS = ('flash_rows_fwd_bf16', 'flash_rows_bwd_bf16', 'conv2d_same_3x3_bf16',
                 'fused_feedforward_bf16', STEM_KERNEL)
VIDEO_KERNELS = ('temporal_attn_fwd_bf16', 'ln_transpose_bf16', 'norm_untranspose_bf16')
FILM_KERNEL = 'fused_film_norm_bf16'
CF_KERNEL = 'conv2d_same_cf_bf16'
# kernels 9 and 11: wired nowhere (as in the JAX package), held at the EDM
# path's LayerNorm and attention-projection sites, which hooks record;
# kernel 7 likewise at the SR-1024 path's final conv
NORM_UNWIRED = ('fused_layernorm_bf16', 'fused_ln_matmul_bf16', 'fused_matmul_ln_bf16')
UNWIRED = (*NORM_UNWIRED, CF_KERNEL)
# measured and logged beside the launched and recorded shapes, weighted by
# nothing: the nearest final conv that the JAX gate admits; BaseUnet64's
# Perceiver at batch 2 and 4 (b x 36 latents), which no path launches; the
# feedforward's staged route (shapes the cluster kernel refuses), at the
# 384-wide 32^2 stage of a default Unet at dim 48 (batch 8) and at k past 512
LOG_ONLY_SHAPES = {CF_KERNEL: ((2, 1024, 1024, 128, 3, 3),),
                   'fused_feedforward_bf16': ((72, 512, 2048, 1e-3), (144, 512, 2048, 1e-3),
                                              (8192, 384, 768, 1e-3), (288, 1024, 1024, 1e-3))}
# kernels whose result must be the same bits on a second call
DETERMINISTIC = ('fused_feedforward_bf16', 'cross_embed_stem_bf16')
PATHS = ('serving', 'training', 'video', 'video_training', 'edm_serving', 'sr1024_serving')


def log(msg):
    print(msg, flush=True)


def cuda_time_ms(fn, iters=10, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time_ms(fn, kernel_name=None, kernels=1, iters=10):
    """Device time per call of the CUDA functions whose names hold
    `kernel_name` (every one, given None) that `fn` launches, from
    torch.profiler: CUDA events over calls of a few microseconds read the
    host's launch time, not the device's. The profiler now and then drops
    kernels from a trace, so each function's time is its mean over the
    launches the trace holds, times its launches per call, and a trace that
    caught fewer than `kernels` distinct such functions is taken again, up
    to three times in all."""
    import torch
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if e.self_device_time_total > 0 and e.count > 0
                and (kernel_name is None or kernel_name in e.key)]
        if len(hits) >= kernels:
            break
    return sum(e.self_device_time_total / e.count * max(1, round(e.count / iters))
               for e in hits) / 1e3


def free_cuda():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def randomize_final_conv(unet, seed):
    """The final conv starts at zero; random values let every weight reach
    the output (and, in training, receive a gradient)."""
    import torch
    g = torch.Generator(device='cuda').manual_seed(seed)
    with torch.no_grad():
        for p in (unet.final_conv.weight, unet.final_conv.bias):
            p.copy_(torch.randn(p.shape, generator=g, device='cuda') * 0.02)


def text_batch(torch, g, n):
    """Mock T5 embeddings (n, 256, 768), zero past a random length, and their mask."""
    emb = torch.randn((n, 256, 768), generator=g, device='cuda')
    lengths = torch.randint(8, 257, (n,), generator=g, device='cuda')
    mask = torch.arange(256, device='cuda')[None] < lengths[:, None]
    return emb * mask[..., None], mask


@contextmanager
def counting_path(build, shapes, counts):
    """Set the launch counts to 0, record the size arguments (those after the
    leading pointers) of every launch into `shapes`, and add the counts of
    the block to `counts`; the wrapped launch still counts."""
    import ctypes
    original = build.launch

    def launch(name, *args):
        sig = build.SIGNATURES[name]
        n_ptr = next(i for i, a in enumerate(sig) if a is not ctypes.c_void_p)
        shapes[name][tuple(args[n_ptr:])] += 1
        return original(name, *args)

    build.reset_launches()
    build.launch = launch
    try:
        yield
    finally:
        build.launch = original
        counts.update(build.LAUNCHES)


def check_launched(counts, names, path):
    ok = True
    for name in names:
        c = counts.get(name, 0)
        ok &= c > 0
        log(f'{path} launches {name}: {c}{"" if c > 0 else " -> FAIL: not on the path"}')
    return ok


# --- serving --------------------------------------------------------------------------

def phase_serving(torch, it, build, results):
    bf16 = torch.bfloat16
    torch.manual_seed(0)
    t0 = time.perf_counter()
    base = it.BaseUnet64(dtype=bf16, text_embed_dim=768, max_text_len=256)
    sr = it.SRUnet256(dtype=bf16, text_embed_dim=768, max_text_len=256, lowres_cond=True)
    randomize_final_conv(base, 1)
    randomize_final_conv(sr, 2)
    imagen = it.Imagen((base, sr), image_sizes=(64, 256), timesteps=TIMESTEPS,
                       cond_drop_prob=0.1).eval()
    n_params = [sum(p.numel() for p in u.parameters()) for u in imagen.unets]
    torch.cuda.synchronize()
    log(f'serving: BaseUnet64 {n_params[0] / 1e9:.3f} B params, SRUnet256 '
        f'{n_params[1] / 1e9:.3f} B params, built in {time.perf_counter() - t0:.1f} s')

    t0 = time.perf_counter()
    server = it.ImagenServer(imagen, batch_size=4, cond_scale=3., seed=0)
    log(f'serving: warmup {time.perf_counter() - t0:.2f} s '
        f'(timesteps {TIMESTEPS}, serving batch 4, cond_scale 3)')

    g = torch.Generator(device='cuda').manual_seed(1234)
    requests = [text_batch(torch, g, n) for n in REQUEST_SIZES]

    counts = Counter()
    torch.cuda.reset_peak_memory_stats()
    ok = True
    with counting_path(build, results['shapes']['serving'], counts):
        for i, (emb, mask) in enumerate(requests):
            t0 = time.perf_counter()
            images = server.generate(text_embeds=emb, text_masks=mask)
            lat = time.perf_counter() - t0
            finite = bool(torch.isfinite(torch.from_numpy(images)).all())
            in_range = bool(images.min() >= 0. and images.max() <= 1.)
            good = images.shape == (emb.shape[0], 256, 256, 3) and finite and in_range
            ok &= good
            log(f'request {i}: n={emb.shape[0]} latency {lat:.3f} s shape {images.shape} '
                f'finite {finite} in [0,1] {in_range} -> {"ok" if good else "FAIL"}')
    ok &= check_launched(counts, ['flash_rows_fwd_bf16', 'conv2d_same_3x3_bf16',
                                  'fused_feedforward_bf16', STEM_KERNEL], 'serving')
    log(f'serving: peak memory allocated during the requests: '
        f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB')
    results['counts']['serving'] = counts
    return ok


# --- training -------------------------------------------------------------------------

def training_imagen(torch, it, unet_number):
    common = dict(dtype=torch.bfloat16, text_embed_dim=768, max_text_len=256)
    if unet_number == 1:
        unets, sizes, steps = (it.BaseUnet64(**common),), (64,), 1000
    else:
        unets = (it.NullUnet(), it.SRUnet256(**common, lowres_cond=True))
        sizes, steps = (64, 256), (1000, 500)
    imagen = it.Imagen(unets, image_sizes=sizes, timesteps=steps, cond_drop_prob=0.1)
    randomize_final_conv(imagen.unets[unet_number - 1], 10 + unet_number)
    return imagen


def train_config(torch, it, build, results, counts, unet_number, batch):
    torch.manual_seed(20 + unet_number)
    t0 = time.perf_counter()
    imagen = training_imagen(torch, it, unet_number)
    size = imagen.image_sizes[unet_number - 1]
    g = torch.Generator(device='cuda').manual_seed(100 + unet_number)
    emb, mask = text_batch(torch, g, batch)
    data = dict(images=torch.rand((batch, size, size, 3), generator=g, device='cuda'),
                text_embeds=emb, text_masks=mask)
    stages = 'BaseUnet64' if unet_number == 1 else 'NullUnet + SRUnet256'
    label = f'train unet {unet_number} ({stages}, batch {batch}, {size}px)'
    return train_steps(torch, it, build, results['shapes']['training'], counts, label, imagen,
                       unet_number, data, t0)


def train_steps(torch, it, build, shapes, counts, label, imagen, unet_number, data, t0):
    """TRAIN_STEPS steps of `ImagenTrainer.step_with_batch` on `data`, with
    the launches counted into `counts`; checks finite losses, a finite
    gradient for every parameter, and that the weights and the EMA moved."""
    unet = imagen.unets[unet_number - 1]
    trainer = it.ImagenTrainer(imagen, lr=1e-4, max_grad_norm=1.0, use_ema=True,
                               ema_update_after_step=0, ema_update_every=1,
                               only_train_unet_number=unet_number, seed=0, verbose=False)
    named = [(n, p) for n, p in unet.named_parameters() if p.requires_grad]
    before = [p.detach().flatten()[:4096].clone() for _, p in named]
    torch.cuda.synchronize()
    n_params = sum(p.numel() for _, p in named)
    log(f'{label}: {n_params / 1e9:.3f} B trainable params, '
        f'built in {time.perf_counter() - t0:.1f} s')

    # every parameter's gradient, checked between the first backward and its update
    grad_report = {}
    apply_update = trainer._apply_update

    def checked_update(index):
        if not grad_report:
            missing = [n for n, p in named if p.grad is None]
            finite = torch.stack([torch.isfinite(p.grad).all() for _, p in named
                                  if p.grad is not None]).cpu()
            grad_report.update(missing=missing, nonfinite=int((~finite).sum()))
        apply_update(index)

    trainer._apply_update = checked_update
    losses = []
    with counting_path(build, shapes, counts):
        for step in range(1, TRAIN_STEPS + 1):
            torch.cuda.reset_peak_memory_stats()
            loss = trainer.step_with_batch(data, unet_number=unet_number)
            losses.append(loss)
            log(f'{label} step {step}: loss {loss:.6f} step time '
                f'{trainer.step_timer.times[-1]:.4f} s peak allocated '
                f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB')
    ok = all(math.isfinite(x) for x in losses)
    grads_ok = not grad_report['missing'] and grad_report['nonfinite'] == 0
    log(f'{label}: after step 1, {len(grad_report["missing"])} parameters without a gradient '
        f'{grad_report["missing"][:5]}, {grad_report["nonfinite"]} with non-finite values '
        f'-> {"ok" if grads_ok else "FAIL"}')
    ema = dict(trainer.ema_unets[unet_number - 1].named_parameters())
    moved = sum(not torch.equal(p.detach().flatten()[:4096], b)
                for (_, p), b in zip(named, before))
    ema_moved = sum(not torch.equal(ema[n].flatten()[:4096], b)
                    and not torch.equal(ema[n], p.detach())
                    for (n, p), b in zip(named, before))
    changed = moved >= 0.9 * len(named) and ema_moved >= 0.9 * len(named)
    log(f'{label}: {moved} of {len(named)} parameter tensors changed, {ema_moved} EMA tensors '
        f'differ from both the start and the online weights -> {"ok" if changed else "FAIL"}; '
        f'trainer.timings() {trainer.timings()}')
    return ok and grads_ok and changed


def phase_training(torch, it, build, results):
    ok = True
    counts = Counter()
    for unet_number, batch in TRAIN_CONFIGS:
        ok &= train_config(torch, it, build, results, counts, unet_number, batch)
        free_cuda()
    ok &= check_launched(counts, IMAGE_KERNELS, 'training')
    results['counts']['training'] = counts
    return ok


# --- video serving ----------------------------------------------------------------------

def video_unet(torch, it, **kwargs):
    """The JAX bench's video `Unet3D` (`bench.py:158-174`) at full width."""
    return it.Unet3D(dim=64, dim_mults=(1, 2, 4), num_resnet_blocks=2, layer_attns=False,
                     layer_cross_attns=(False, True, True), text_embed_dim=768,
                     max_text_len=256, dtype=torch.bfloat16, **kwargs)


def phase_video(torch, it, build, results):
    """The JAX bench's video configuration (`bench.py`, mode 'video') at full
    width: 16 frames of 64 px, batch 1 (2 with CFG), cond_scale 3."""
    torch.manual_seed(30)
    t0 = time.perf_counter()
    unet = video_unet(torch, it)
    randomize_final_conv(unet, 31)
    imagen = it.Imagen((unet,), image_sizes=(64,), timesteps=VIDEO_STEPS,
                       cond_drop_prob=0.1).eval()
    torch.cuda.synchronize()
    log(f'video: Unet3D {sum(p.numel() for p in unet.parameters()) / 1e6:.1f} M params, '
        f'built in {time.perf_counter() - t0:.1f} s')

    t0 = time.perf_counter()
    server = it.ImagenServer(imagen, batch_size=1, video_frames=VIDEO_FRAMES, cond_scale=3.,
                             seed=0)
    log(f'video: warmup {time.perf_counter() - t0:.2f} s (timesteps {VIDEO_STEPS}, '
        f'{VIDEO_FRAMES} frames, serving batch 1, cond_scale 3)')

    g = torch.Generator(device='cuda').manual_seed(4321)
    requests = [text_batch(torch, g, 1) for _ in range(3)]
    counts = Counter()
    ok = True
    with counting_path(build, results['shapes']['video'], counts):
        for i, (emb, mask) in enumerate(requests):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            video = server.generate(text_embeds=emb, text_masks=mask)
            lat = time.perf_counter() - t0
            finite = bool(torch.isfinite(torch.from_numpy(video)).all())
            in_range = bool(video.min() >= 0. and video.max() <= 1.)
            good = video.shape == (1, VIDEO_FRAMES, 64, 64, 3) and finite and in_range
            ok &= good
            log(f'video request {i}: latency {lat:.3f} s shape {video.shape} finite {finite} '
                f'in [0,1] {in_range} peak allocated '
                f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB '
                f'-> {"ok" if good else "FAIL"}')
    ok &= check_launched(counts, ['temporal_attn_fwd_bf16', 'flash_rows_fwd_bf16', STEM_KERNEL],
                         'video')
    expected = VIDEO_TEMPORAL_SITES * VIDEO_STEPS * len(requests)
    per_step = counts['temporal_attn_fwd_bf16'] == expected
    ok &= per_step
    log(f'video: temporal kernel launches {counts["temporal_attn_fwd_bf16"]}, expected '
        f'{VIDEO_TEMPORAL_SITES} per step x {VIDEO_STEPS} steps x {len(requests)} requests = '
        f'{expected} -> {"ok" if per_step else "FAIL"}')
    results['counts']['video'] = counts
    return ok


# --- video training ---------------------------------------------------------------------

def fused_site_calls(unet):
    """Forward hooks that count the TemporalAttention calls taking the fused
    route (kernels 12 and 13 once each): the expected launches, read from
    the built model as it runs."""
    from imagen_tpu_torch.models.video_blocks import TemporalAttention
    from imagen_tpu_torch.ops.temporal_layout import temporal_layout_available
    calls = Counter()

    def hook(module, args):
        x = args[0]
        if module.fused_ln and temporal_layout_available(x.shape, x.dtype, x.device.type):
            calls[tuple(x.shape)] += 1

    handles = [m.register_forward_pre_hook(hook) for m in unet.modules()
               if isinstance(m, TemporalAttention)]
    return calls, handles


def phase_video_training(torch, it, build, results):
    """The video `Unet3D` with the fused temporal norms on, trained for
    TRAIN_STEPS steps on batch 4 clips of 16 frames at 64 px."""
    torch.manual_seed(40)
    t0 = time.perf_counter()
    unet = video_unet(torch, it, temporal_fused_ln=True)
    randomize_final_conv(unet, 41)
    imagen = it.Imagen((unet,), image_sizes=(64,), cond_drop_prob=0.1)
    g = torch.Generator(device='cuda').manual_seed(140)
    emb, mask = text_batch(torch, g, VIDEO_TRAIN_BATCH)
    data = dict(images=torch.rand((VIDEO_TRAIN_BATCH, VIDEO_FRAMES, 64, 64, 3), generator=g,
                                  device='cuda'),
                text_embeds=emb, text_masks=mask)
    label = (f'video train (Unet3D {sum(p.numel() for p in unet.parameters()) / 1e6:.1f} M, '
             f'batch {VIDEO_TRAIN_BATCH} x {VIDEO_FRAMES} frames, 64px)')
    counts = Counter()
    calls, handles = fused_site_calls(unet)
    try:
        ok = train_steps(torch, it, build, results['shapes']['video_training'], counts, label,
                         imagen, 1, data, t0)
    finally:
        for h in handles:
            h.remove()
    ok &= check_launched(counts, ['flash_rows_fwd_bf16', 'flash_rows_bwd_bf16', *VIDEO_KERNELS,
                                  STEM_KERNEL], 'video_training')
    expected = sum(calls.values())
    sites = {shape: n // TRAIN_STEPS for shape, n in sorted(calls.items())}
    for name in ('ln_transpose_bf16', 'norm_untranspose_bf16'):
        exact = counts[name] == expected > 0
        ok &= exact
        log(f'video_training: {name} launches {counts[name]}, expected {expected} = fused '
            f'sites per forward {sites} x {TRAIN_STEPS} steps -> {"ok" if exact else "FAIL"}')
    results['counts']['video_training'] = counts
    return ok


# --- EDM serving -----------------------------------------------------------------------

def film_norms(unet, fused):
    """Turn kernel 8 on or off in every ChanRMSNorm of `unet` (the weights stay)."""
    from imagen_tpu_torch.models.blocks import ChanRMSNorm
    for m in unet.modules():
        if isinstance(m, ChanRMSNorm):
            m.fused = fused


def site_hooks(imagen):
    """Forward pre-hooks, while the requests run, that count the calls taking
    kernel 8 per unet (the expected launches), and record the shapes of the
    LayerNorm sites (kernel 9: rows, C, stable, eps) and of the attention
    pre-norm -> to_q (+ to_kv) and to_out -> out-norm sites (kernel 11:
    rows, k, n, eps) that the gates admit, as the kernels' launches would
    record them. Returns (film calls by unet, sites by kernel, refused
    sites by kernel, handles)."""
    from imagen_tpu_torch.models import blocks
    from imagen_tpu_torch.ops import fused_norm as fn
    film_calls, sites, refused = Counter(), defaultdict(Counter), Counter()

    def film_hook(index):
        def hook(module, args, kwargs):
            x = args[0]
            if module.fused and fn.fused_film_available(x.shape, x.dtype, x.device.type,
                                                        kwargs.get('fuse_silu', False)):
                film_calls[index] += 1
        return hook

    def record(name, dims, admitted):
        if admitted:
            sites[name][dims] += 1
        else:
            refused[name] += 1

    def ln_hook(module, args, kwargs):
        x = args[0]
        c = x.shape[-1]
        rows = x.numel() // c
        record(fn.LN_KERNEL, (rows, c, int(module.stable), blocks.ln_eps(x.dtype)),
               fn.fused_layernorm_available(rows, c, x.dtype))

    def attn_hook(module, args, kwargs):
        x = args[0]
        k = x.shape[-1]
        rows = x.numel() // k
        n = module.to_q.out_features
        if isinstance(module, blocks.Attention):   # to_kv reads the same normalised x
            n += module.to_kv.out_features
        eps = blocks.ln_eps(x.dtype)
        record(fn.LNMM_KERNEL, (rows, k, n, eps), fn.fused_lnmm_available(rows, k, n, x.dtype))
        inner = module.to_out[0].in_features
        record(fn.MMLN_KERNEL, (rows, inner, k, eps),
               fn.fused_lnmm_available(rows, inner, k, x.dtype))

    handles = []
    for index, unet in enumerate(imagen.unets):
        for m in unet.modules():
            if isinstance(m, blocks.ChanRMSNorm):
                handles.append(m.register_forward_pre_hook(film_hook(index), with_kwargs=True))
            elif isinstance(m, blocks.LayerNorm):
                handles.append(m.register_forward_pre_hook(ln_hook, with_kwargs=True))
            elif isinstance(m, (blocks.Attention, blocks.CrossAttention)):
                handles.append(m.register_forward_pre_hook(attn_hook, with_kwargs=True))
    return film_calls, sites, refused, handles


def edm_request(torch, server, emb, mask, label):
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    images = server.generate(text_embeds=emb, text_masks=mask,
                             generator=torch.Generator(device='cuda').manual_seed(99))
    lat = time.perf_counter() - t0
    finite = bool(torch.isfinite(torch.from_numpy(images)).all())
    in_range = bool(images.min() >= 0. and images.max() <= 1.)
    good = images.shape == (emb.shape[0], 256, 256, 3) and finite and in_range
    log(f'{label}: n={emb.shape[0]} latency {lat:.3f} s shape {images.shape} finite {finite} '
        f'in [0,1] {in_range} peak allocated {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} '
        f'GiB -> {"ok" if good else "FAIL"}')
    return good, images, lat


def phase_edm_serving(torch, it, build, results):
    """`ElucidatedImagen` over BaseUnet64 -> SRUnet256 at paper widths with
    `fused_film=True` (kernel 8 at every 2-D Block), the churn + Heun
    sampler at EDM_STEPS (2N - 1 forwards per stage), S_churn 80; a server
    at batch 4, cond_scale 3, three requests; then the same weights with
    kernel 8 on and off in turns."""
    bf16 = torch.bfloat16
    torch.manual_seed(50)
    t0 = time.perf_counter()
    common = dict(dtype=bf16, text_embed_dim=768, max_text_len=256, fused_film=True)
    base, sr = it.BaseUnet64(**common), it.SRUnet256(**common, lowres_cond=True)
    randomize_final_conv(base, 51)
    randomize_final_conv(sr, 52)
    imagen = it.ElucidatedImagen((base, sr), image_sizes=(64, 256), num_sample_steps=EDM_STEPS,
                                 cond_drop_prob=0.1).eval()
    torch.cuda.synchronize()
    log(f'edm_serving: ElucidatedImagen (BaseUnet64 -> SRUnet256, fused_film) built in '
        f'{time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    server = it.ImagenServer(imagen, batch_size=4, cond_scale=3., seed=0)
    log(f'edm_serving: warmup {time.perf_counter() - t0:.2f} s (steps {EDM_STEPS}, '
        f'S_churn {imagen.hparams[0].S_churn}, serving batch 4, cond_scale 3)')

    g = torch.Generator(device='cuda').manual_seed(5678)
    requests = [text_batch(torch, g, n) for n in REQUEST_SIZES]
    counts = Counter()
    ok = True
    film_calls, sites, refused, handles = site_hooks(imagen)
    try:
        with counting_path(build, results['shapes']['edm_serving'], counts):
            for i, (emb, mask) in enumerate(requests):
                ok &= edm_request(torch, server, emb, mask, f'edm request {i}')[0]
    finally:
        for h in handles:
            h.remove()
    ok &= check_launched(counts, [FILM_KERNEL, 'flash_rows_fwd_bf16', 'conv2d_same_3x3_bf16',
                                  'fused_feedforward_bf16', STEM_KERNEL], 'edm_serving')
    forwards = [2 * n - 1 for n in EDM_STEPS]
    per_forward = {i: film_calls[i] / (forwards[i] * len(requests)) for i in range(2)}
    expected = sum(film_calls.values())
    exact = counts[FILM_KERNEL] == expected > 0 and all(
        film_calls[i] % (forwards[i] * len(requests)) == 0 for i in range(2))
    ok &= exact
    log(f'edm_serving: {FILM_KERNEL} launches {counts[FILM_KERNEL]}, expected {expected} = '
        f'fused sites per forward {per_forward} (BaseUnet64, SRUnet256) x forwards {forwards} '
        f'(2N - 1) x {len(requests)} requests -> {"ok" if exact else "FAIL"}')
    for name in NORM_UNWIRED:
        log(f'edm_serving: {name} sites (no launch: wired nowhere) '
            f'{sum(sites[name].values())} at {len(sites[name])} shapes; gate refused '
            f'{refused[name]}')
    results['counts']['edm_serving'] = counts
    results['sites']['edm_serving'] = {name: sites[name] for name in NORM_UNWIRED}

    # kernel 8 on and off on the same weights, in turns
    emb, mask = requests[0]
    outputs, lats = {}, defaultdict(list)
    for fused in (True, False, False, True, True, False):
        for unet in imagen.unets:
            film_norms(unet, fused)
        good, outputs[fused], lat = edm_request(torch, server, emb, mask,
                                                f'edm A/B fused_film={fused}')
        ok &= good
        lats[fused].append(lat)
    log(f'edm_serving A/B: fused_film on {[round(x, 3) for x in lats[True]]} s, off '
        f'{[round(x, 3) for x in lats[False]]} s per request of {emb.shape[0]}; max |on - off| '
        f'of the images {float(abs(outputs[True] - outputs[False]).max()):.3e}')

    # kernel 14 on and off (its gate closed) on the same weights, in turns, kernel 8 on
    outputs, lats = {}, defaultdict(list)
    for on in (True, False, False, True):
        with open_or_closed(on, 'stem_available'):
            good, outputs[on], lat = edm_request(torch, server, emb, mask,
                                                 f'edm A/B stem kernel={on}')
        ok &= good
        lats[on].append(lat)
    log(f'edm_serving A/B: stem kernel on {[round(x, 3) for x in lats[True]]} s, off '
        f'{[round(x, 3) for x in lats[False]]} s per request of {emb.shape[0]}; max |on - off| '
        f'of the images {float(abs(outputs[True] - outputs[False]).max()):.3e}')
    return ok


# --- SR-1024 serving --------------------------------------------------------------------

def sr1024_hooks(unet):
    """Forward pre-hooks, while the requests run, that count the calls taking
    kernel 14 (a stride-1 `CrossEmbedLayer` whose gate admits the input)
    and kernel 6 (a `SameConv3x3` whose gate admits it): the
    expected launches, read from the built net. A hook also records the
    final conv's input as kernel 7's arguments (b, H, W, cin, cout, k).
    Returns (calls, final-conv sites, handles)."""
    from imagen_tpu_torch.models import blocks
    from imagen_tpu_torch.ops.conv2d import conv2d_same_available
    from imagen_tpu_torch.ops.stem_conv import stem_available
    calls, final_sites = Counter(), Counter()

    def stem_hook(module, args):
        x = args[0]
        if module.stride == 1 and stem_available(tuple(x.shape), module.kernel_sizes,
                                                 module.convs[0].compute_dtype, x.device.type):
            calls[STEM_KERNEL] += 1

    def conv_hook(module, args):
        x = args[0]
        w_shape = (3, 3, module.in_channels, module.out_channels)
        if conv2d_same_available(tuple(x.shape), w_shape, module.compute_dtype, x.device.type):
            calls['conv2d_same_3x3_bf16'] += 1

    def final_hook(module, args):
        final_sites[(*args[0].shape, module.out_channels, module.kernel_size[0])] += 1

    handles = [unet.final_conv.register_forward_pre_hook(final_hook)]
    for m in unet.modules():
        if isinstance(m, blocks.CrossEmbedLayer):
            handles.append(m.register_forward_pre_hook(stem_hook))
        elif isinstance(m, blocks.SameConv3x3):
            handles.append(m.register_forward_pre_hook(conv_hook))
    return calls, final_sites, handles


def sr1024_request(torch, imagen, emb, mask, start, label):
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    images = imagen.sample(text_embeds=emb, text_masks=mask, cond_scale=3.,
                           start_at_unet_number=2, start_image_or_video=start,
                           generator=torch.Generator(device='cuda').manual_seed(77))
    torch.cuda.synchronize()
    lat = time.perf_counter() - t0
    finite = bool(torch.isfinite(images).all())
    in_range = bool(images.min() >= 0. and images.max() <= 1.)
    good = tuple(images.shape) == (1, 1024, 1024, 3) and finite and in_range
    log(f'{label}: latency {lat:.3f} s shape {tuple(images.shape)} finite {finite} in [0,1] '
        f'{in_range} peak allocated {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB '
        f'-> {"ok" if good else "FAIL"}')
    return good, images, lat


def phase_sr1024_serving(torch, it, build, results):
    """The JAX bench's `sr1024_paper` (`bench.py:124-127`, `:442-445`):
    `NullUnet` + `SRUnet1024` at paper widths, its stem on kernel 14,
    sampled from `start_at_unet_number=2` on a seeded 256 px image, batch 1
    (2 with CFG), cond_scale 3, SR_STEPS steps; then the same weights with
    kernel 14 on and off (its gate closed) in turns."""
    from torch.utils.flop_counter import FlopCounterMode
    bf16 = torch.bfloat16
    torch.manual_seed(60)
    t0 = time.perf_counter()
    # lowres_cond as the cascade casts the second stage, built once
    sr = it.SRUnet1024(dtype=bf16, text_embed_dim=768, max_text_len=256, lowres_cond=True)
    randomize_final_conv(sr, 61)
    imagen = it.Imagen((it.NullUnet(), sr), image_sizes=(256, 1024),
                       timesteps=(2 * SR_STEPS, SR_STEPS), cond_drop_prob=0.1).eval()
    unet = imagen.unets[1]
    torch.cuda.synchronize()
    log(f'sr1024_serving: NullUnet + SRUnet1024 {sum(p.numel() for p in unet.parameters()) / 1e9:.3f}'
        f' B params, built in {time.perf_counter() - t0:.1f} s; steps {SR_STEPS}, '
        f'batch 1 (2 with CFG), cond_scale 3')

    g = torch.Generator(device='cuda').manual_seed(6060)
    emb, mask = text_batch(torch, g, 1)
    start = torch.rand((1, 256, 256, 3), generator=g, device='cuda')
    ok = sr1024_request(torch, imagen, emb, mask, start, 'sr1024 warm-up')[0]

    counts = Counter()
    calls, final_sites, handles = sr1024_hooks(unet)
    try:
        with counting_path(build, results['shapes']['sr1024_serving'], counts):
            for i in range(3):
                ok &= sr1024_request(torch, imagen, emb, mask, start, f'sr1024 request {i}')[0]
    finally:
        for h in handles:
            h.remove()
    # the flash forward at mid_attn (64^2 tokens) and the feedforward in the Perceiver
    ok &= check_launched(counts, [STEM_KERNEL, 'conv2d_same_3x3_bf16', 'flash_rows_fwd_bf16',
                                  'fused_feedforward_bf16'], 'sr1024_serving')
    for name in (STEM_KERNEL, 'conv2d_same_3x3_bf16'):
        exact = counts[name] == calls[name] > 0
        ok &= exact
        log(f'sr1024_serving: {name} launches {counts[name]}, hook count {calls[name]} '
            f'({calls[name] / (3 * SR_STEPS):g} a forward x {SR_STEPS} steps x 3 requests) '
            f'-> {"ok" if exact else "FAIL"}')
    log(f'sr1024_serving: {CF_KERNEL} site (no launch: wired nowhere, as in JAX) '
        f'{dict(final_sites)}; also held at the JAX-gate shape {LOG_ONLY_SHAPES[CF_KERNEL]}')
    results['counts']['sr1024_serving'] = counts
    results['sites']['sr1024_serving'] = {CF_KERNEL: final_sites}

    # the device FLOPs of one CFG-doubled forward, on the plain route (the
    # counter sees aten ops, not the kernels' launches; the function is the same)
    x = torch.randn((2, 1024, 1024, 3), generator=g, device='cuda')
    tt = torch.rand((2,), generator=g, device='cuda')
    with torch.no_grad(), plain_path(), FlopCounterMode(display=False) as flop_counter:
        unet(x, tt, text_embeds=emb.repeat(2, 1, 1), text_mask=mask.repeat(2, 1),
             lowres_cond_img=x, lowres_noise_times=tt)
    flops = flop_counter.get_total_flops()
    log(f'sr1024_serving: {flops / 1e12:.3f} TFLOP per CFG-doubled forward '
        f'(torch.utils.flop_counter), {flops * SR_STEPS / 1e12:.1f} TFLOP a request')
    del x
    free_cuda()

    # kernel 14 on and off (its gate closed) on the same weights, in turns
    outputs, lats = {}, defaultdict(list)
    for on in (True, False, False, True):
        with open_or_closed(on, 'stem_available'):
            good, outputs[on], lat = sr1024_request(torch, imagen, emb, mask, start,
                                                    f'sr1024 A/B stem kernel={on}')
        ok &= good
        lats[on].append(lat)
    log(f'sr1024_serving A/B: stem kernel on {[round(v, 3) for v in lats[True]]} s, off '
        f'{[round(v, 3) for v in lats[False]]} s; max |on - off| of the images '
        f'{float((outputs[True] - outputs[False]).abs().max()):.3e}; '
        f'achieved {flops * SR_STEPS / min(lats[True]) / 1e12:.1f} TFLOP/s at the fastest on')

    # kernel 6 on and off (cuDNN at its sites), one profiled request each
    busy, conv_ms = {}, {}
    for on in (True, False):
        with open_or_closed(on, 'conv2d_same_available'):
            sr1024_request(torch, imagen, emb, mask, start, f'sr1024 conv kernel={on} (unprofiled)')
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                good, _, lat = sr1024_request(torch, imagen, emb, mask, start,
                                              f'sr1024 profiled, conv kernel={on}')
        ok &= good
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        busy[on] = sum(e.self_device_time_total for e in events) / 1e3
        conv = [e for e in events if KERNEL_INFO['conv2d_same_3x3_bf16']['device_kernel'] in e.key]
        conv_ms[on] = sum(e.self_device_time_total for e in conv) / 1e3
        log(f'sr1024_serving profiled, conv kernel {on}: latency {lat:.3f} s, device busy '
            f'{busy[on]:.1f} ms; kernel 6 {conv_ms[on]:.1f} ms over '
            f'{sum(e.count for e in conv)} launches, {conv_ms[on] / busy[on]:.1%} of the '
            f'device time')
    log(f'sr1024_serving: cuDNN at kernel 6\'s sites, by the difference of the two profiled '
        f'requests: {conv_ms[True] + busy[False] - busy[True]:.1f} ms against kernel 6\'s '
        f'{conv_ms[True]:.1f} ms')
    return ok


# --- each kernel against its plain version --------------------------------------------

def kernel_cases(torch, name, dims, g):
    """(kernel, plain, library or None, served or None, unfused or None,
    bf16 inputs, fp32 inputs, flops, bytes) at one recorded launch shape.
    kernel and plain return tuples of outputs; `served` is the flash forward
    as serving calls it, without the LSE that training asks for; `unfused`
    is the port's unfused route for kernels 12 and 13."""
    import torch.nn.functional as F
    from imagen_tpu_torch.ops import conv2d as c2d
    from imagen_tpu_torch.ops import flash_attention as fa
    from imagen_tpu_torch.ops import fused_norm as fn
    from imagen_tpu_torch.ops import stem_conv as stem
    from imagen_tpu_torch.ops import temporal_layout as tl
    from imagen_tpu_torch.ops.tensor_utils import l2norm
    bf16 = torch.bfloat16
    unfused = None

    def rnd(*shape, scale=1.):
        return torch.randn(shape, generator=g, device='cuda') * scale

    served = None
    if name == fa.KERNEL:
        b, rows, nk, d, scale2 = dims
        scale = scale2 / fa.LOG2E
        qs, ks = 1. + rnd(d, scale=0.1), 1. + rnd(d, scale=0.1)
        inputs = [rnd(b, rows, d).to(bf16), rnd(b, nk, d).to(bf16), rnd(b, nk, d).to(bf16)]
        qn, kn = fa.l2norm_scale(inputs[0], qs), fa.l2norm_scale(inputs[1], ks)

        def kernel(q, k, v):
            return fa._rows_forward(q, fa.l2norm_scale(k, ks), v, scale, qs, with_lse=True)

        def plain(q, k, v):
            return fa.flash_rows_reference(q, fa.l2norm_scale(k, ks), v, scale, qs,
                                           return_lse=True)

        def library(q, k, v):   # SDPA alone: q and k normalised beforehand
            return F.scaled_dot_product_attention(qn[:, None], kn[:, None], v[:, None],
                                                  scale=scale)

        def served(q, k, v):
            return fa.flash_cosine_mqa_rows(q, k, v, qs, ks, scale)
        flops = 4 * b * rows * nk * d
        nbytes = 2 * (2 * b * rows * d + 2 * b * nk * d) + 4 * b * rows
    elif name == fa.TEMPORAL_KERNEL:
        P, f, h, nk, d, scale2 = dims
        scale = scale2 / fa.LOG2E
        qs = 1. + rnd(d, scale=0.1)
        causal = torch.ones((f, nk), dtype=torch.bool, device='cuda').triu(nk - f + 1)
        bias = fa.build_grouped_bias(rnd(h, f, nk), causal)
        kn = fa.l2norm_scale(rnd(P, nk, d).to(bf16), 1. + rnd(d, scale=0.1))
        inputs = [rnd(P, f, h * d).to(bf16), kn, rnd(P, nk, d).to(bf16)]
        qn = fa.l2norm_scale(inputs[0].reshape(P, f, h, d), qs).transpose(1, 2)
        mask = bias.to(bf16)

        def kernel(q, k, v):
            return (fa._temporal_forward(q, k, v, qs, bias, scale, h),)

        def plain(q, k, v):
            return (fa.temporal_attention_reference(q, k, v, qs, bias, scale, h),)

        def library(q, k, v):
            return F.scaled_dot_product_attention(
                qn, k[:, None].expand(P, h, nk, d), v[:, None].expand(P, h, nk, d),
                attn_mask=mask, scale=scale)
        flops = 4 * P * f * h * nk * d
        nbytes = 2 * (2 * P * f * h * d + 2 * P * nk * d) + 4 * (h * f * nk + d)
    elif name == fa.BWD_KERNEL:
        b, rows, nk, d, _splits, scale = dims
        q, k = (fa.l2norm_scale(rnd(b, n, d), torch.ones(d, device='cuda')) for n in (rows, nk))
        v, do = rnd(b, nk, d), rnd(b, rows, d)
        q, k, v, do = (x.to(bf16) for x in (q, k, v, do))
        out, lse = fa.flash_rows_reference(q.float(), k.float(), v.float(), scale,
                                           return_lse=True)
        delta = fa._delta(do, out)
        inputs = [q, k, v, do]

        def kernel(q, k, v, do):
            return fa.flash_rows_backward(q, k, v, do, lse, delta, scale)

        def plain(q, k, v, do):
            return fa.flash_rows_backward_reference(q, k, v, do, lse, delta, scale)

        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*(x[:, None] for x in leaves), scale=scale)
        lib_do = do[:, None]

        def library(*_):
            return torch.autograd.grad(lib_out, leaves, lib_do, retain_graph=True)
        flops = 10 * b * rows * nk * d
        nbytes = 2 * (4 * b * rows * d + 4 * b * nk * d) + 8 * b * rows
    elif name == c2d.KERNEL:
        b, H, W, cin, cout = dims[:5]   # then the tiling: rows, stages, grid
        inputs = [rnd(b, H, W, cin).to(bf16),
                  rnd(3, 3, cin, cout, scale=(9 * cin) ** -0.5).to(bf16),
                  rnd(cout, scale=0.1).to(bf16)]
        w_oihw = inputs[1].permute(3, 2, 0, 1).contiguous()

        def kernel(x, w, bias):
            return (c2d.conv2d_same(x, w, bias),)

        def plain(x, w, bias):
            return (c2d.conv2d_same_reference(x, w, bias),)

        def library(x, w, bias):
            return F.conv2d(x.permute(0, 3, 1, 2), w_oihw, bias, padding=1)
        flops = 2 * b * H * W * 9 * cin * cout
        nbytes = 2 * (b * H * W * (cin + cout) + 9 * cin * cout + cout)
    elif name == stem.KERNEL:
        b, H, W, c, n, *kd = dims
        ks, ds = kd[:n], kd[stem.MAX_SCALES:stem.MAX_SCALES + n]
        ws = [rnd(k, k, c, d, scale=(k * k * c) ** -0.5).to(bf16) for k, d in zip(ks, ds)]
        inputs = [rnd(b, H, W, c).to(bf16), rnd(sum(ds), scale=0.1).to(bf16), *ws]
        w_oihw = [w.permute(3, 2, 0, 1).contiguous() for w in ws]
        packed = stem.pack_stem_weights(ws)   # kept by the module between calls
        library = None

        def kernel(x, bias, *ws):
            return (stem.cross_embed_stem(x, list(ws), bias, packed=packed),)

        def plain(x, bias, *ws):
            return (stem.cross_embed_stem_reference(x, list(ws), bias),)

        def unfused(x, bias, *_):   # CrossEmbedLayer without the kernel: a conv per scale, cat
            xc = x.permute(0, 3, 1, 2)
            return torch.cat([F.conv2d(xc, w, bb, padding=w.shape[-1] // 2)
                              for w, bb in zip(w_oihw, bias.split(ds))], 1).permute(0, 2, 3, 1)
        flops = 2 * b * H * W * c * sum(k * k * d for k, d in zip(ks, ds))
        nbytes = 2 * (b * H * W * (c + sum(ds)) + sum(k * k * c * d for k, d in zip(ks, ds))
                      + sum(ds))
    elif name == c2d.CF_KERNEL:
        b, H, W, cin, cout, k = dims
        inputs = [rnd(b, H, W, cin).to(bf16),
                  rnd(k, k, cin, cout, scale=(k * k * cin) ** -0.5).to(bf16),
                  rnd(cout, scale=0.1).to(bf16)]
        w_oihw = inputs[1].permute(3, 2, 0, 1).contiguous()

        def kernel(x, w, bias):
            return (c2d.conv2d_same_cf(x, w, bias),)

        def plain(x, w, bias):
            return (c2d.conv2d_same_cf_reference(x, w, bias),)

        def library(x, w, bias):   # the NHWC view's conv is the channel-first output
            return F.conv2d(x.permute(0, 3, 1, 2), w_oihw, bias, padding=k // 2)
        flops = 2 * b * H * W * k * k * cin * cout
        nbytes = 2 * (b * H * W * (cin + cout) + k * k * cin * cout + cout)
    elif name in (tl.LN_T_KERNEL, tl.NORM_UT_KERNEL):
        b, f, hw, c, eps = dims
        gain = 1. + rnd(c, scale=0.1)
        x = rnd(b, f, hw, 1, c).to(bf16)   # (b, f, h, w, c) with h = hw, w = 1
        numel = x.numel()
        library = None
        if name == tl.LN_T_KERNEL:
            inputs = [x]

            def kernel(x):
                return (tl._ln_t_forward(x, gain, eps),)

            def plain(x):
                return (tl.ln_transpose_reference(x, gain, eps),)

            def unfused(x):   # the route without the kernel: fold (a copy), then the norm
                return fn.layernorm(tl._fold(x), gain, eps)
            nbytes = 2 * 2 * numel + 4 * c
        else:
            inputs = [rnd(b * hw, f, c, scale=2.).to(bf16), x]

            def kernel(out, res):
                return (tl._norm_ut_forward(out, res, gain, eps),)

            def plain(out, res):
                return (tl.norm_untranspose_reference(out, res, gain, eps),)

            def unfused(out, res):   # the norm, the unfold, the residual add
                return tl._unfold(fn.layernorm(out, gain, eps), res.shape) + res
            nbytes = 3 * 2 * numel + 4 * c
        flops = 6 * numel
    elif name == fn.FILM_KERNEL:
        b, hw, c, stride = dims
        gamma = 1. + rnd(c, scale=0.1)
        # scale and shift as the ResnetBlock hands them over: strided halves of one
        # (b, 2C) time-MLP output; none for a ResnetBlock's first Block
        scale = shift = None
        if stride:
            scale, shift = rnd(b, 2 * c, scale=0.5).to(bf16)[:, None, None, :].chunk(2, dim=-1)
        inputs = [rnd(b, hw, 1, c).to(bf16)]
        library = None

        def kernel(x):
            return (fn.fused_film_norm(x, gamma, scale, shift),)

        def plain(x):
            return (fn.film_norm_reference(x, gamma, scale, shift),)

        def unfused(x):   # ChanRMSNorm's unfused chain in x's dtype
            out = l2norm(x) * (c ** 0.5) * gamma.to(x.dtype)
            if scale is not None:
                out = out * (scale + 1) + shift
            return F.silu(out)
        flops = 10 * b * hw * c
        nbytes = 2 * 2 * b * hw * c + 4 * c + (2 * 2 * b * c if stride else 0)
    elif name == fn.LN_KERNEL:
        rows, c, stable, eps = dims
        g_ln = 1. + rnd(c, scale=0.1)
        inputs = [rnd(rows, c).to(bf16)]

        def kernel(x):
            return (fn.fused_layernorm(x, g_ln, bool(stable), eps),)

        def plain(x):
            return (fn.layernorm_reference(x, g_ln, bool(stable), eps),)

        def library(x):
            return F.layer_norm(x, (c,), g_ln.to(x.dtype), eps=eps)
        library = None if stable else library
        flops = 8 * rows * c
        nbytes = 2 * 2 * rows * c + 4 * c
    elif name in (fn.LNMM_KERNEL, fn.MMLN_KERNEL):
        rows, k, n, eps = dims
        ln_first = name == fn.LNMM_KERNEL
        g_ln = 1. + rnd(k if ln_first else n, scale=0.1)
        inputs = [rnd(rows, k).to(bf16), rnd(n, k, scale=k ** -0.5).to(bf16)]
        library = None
        if ln_first:
            def kernel(x, w):
                return (fn.fused_ln_matmul(x, g_ln, w, eps),)

            def plain(x, w):
                return (fn.ln_matmul_reference(x, g_ln, w, eps),)
        else:
            def kernel(x, w):
                return (fn.fused_matmul_ln(x, w, g_ln, eps),)

            def plain(x, w):
                return (fn.matmul_ln_reference(x, w, g_ln, eps),)
        unfused = plain   # the module chain: the LayerNorm module, then the Linear (or back)
        flops = 2 * rows * k * n
        nbytes = 2 * (rows * k + n * k + rows * n) + 4 * (k if ln_first else n)
    else:
        from imagen_tpu_torch.models import blocks
        rows, k, hid, eps = dims[:4]   # then the tiling: cluster, stages
        g0, g1 = 1. + rnd(k, scale=0.1), 1. + rnd(hid, scale=0.1)
        inputs = [rnd(rows, k).to(bf16), rnd(hid, k, scale=k ** -0.5).to(bf16),
                  rnd(k, hid, scale=hid ** -0.5).to(bf16)]
        # the FeedForward module at this site, fp32 parameters as the nets hold them
        ff = blocks.FeedForward(k, mult=hid / k, dtype=bf16).cuda().eval()
        with torch.no_grad():
            for param, value in zip((ff[0].g, ff[1].weight, ff[3].g, ff[4].weight),
                                    (g0, inputs[1], g1, inputs[2])):
                param.copy_(value)

        def kernel(x, w0, w1):
            return (fn.fused_feedforward(x, g0, w0, g1, w1, eps),)

        def plain(x, w0, w1):
            return (fn.feedforward_reference(x, g0, w0, g1, w1, eps),)

        def unfused(x, *_):   # the module's own chain with its gate closed: cuBLAS linears
            with open_or_closed(False, 'fused_feedforward_available'):
                return ff(x)
        library = None
        flops = 4 * rows * k * hid
        nbytes = 2 * (2 * rows * k + 2 * k * hid) + 4 * (k + hid)
    return (kernel, plain, library, served, unfused, inputs, [x.float() for x in inputs], flops,
            nbytes)


def log_weight_copy(torch):
    """The device time of one contiguous copy of `SameConv3x3`'s permuted bf16
    weight view at the (3, 3, 2048, 1024) site, the copy the conv wrapper's
    `kernel_weight` makes, beside a zero pad followed by `.contiguous()`,
    which copies twice."""
    import torch.nn.functional as F
    view = torch.randn((1024, 2048, 3, 3), device='cuda').to(torch.bfloat16).permute(2, 3, 1, 0)
    one = device_time_ms(view.contiguous)
    two = device_time_ms(lambda: F.pad(view, (0, 0)).contiguous())
    log(f'conv weight copy at (3, 3, 2048, 1024), {view.numel() * 2 / 1e6:.1f} MB: one copy '
        f'{one:.4f} ms on the device; a zero pad then .contiguous() {two:.4f} ms')


def phase_kernels(torch, results):
    g = torch.Generator(device='cuda').manual_seed(7)
    ok = True
    summary = []
    log_weight_copy(torch)
    for name, info in KERNEL_INFO.items():
        worst = 0.
        totals = defaultdict(float)
        lib_total = None
        by_dims = defaultdict(Counter)
        for path, shapes in results['shapes'].items():
            for dims, count in shapes[name].items():
                by_dims[dims][path] += count
        for path, sites in results['sites'].items():
            for dims, count in sites.get(name, {}).items():
                by_dims[dims][f'{path} sites'] += count
        for dims in LOG_ONLY_SHAPES.get(name, ()):
            by_dims[dims]['log only'] += 0
        for dims, counts in sorted(by_dims.items()):
            count = sum(counts.values())
            kernel, plain, library, served, unfused, xb, xf, flops, nbytes = kernel_cases(
                torch, name, dims, g)
            with torch.no_grad():
                truth = plain(*xf)
                first = kernel(*xb)
                errs_k = [(o.float() - t).abs().max().item() for o, t in zip(first, truth)]
                errs_p = [(o.float() - t).abs().max().item() for o, t in zip(plain(*xb), truth)]
                same = (name not in DETERMINISTIC
                        or all(torch.equal(a, b) for a, b in zip(first, kernel(*xb))))
                del truth, first
                # kernel and plain in turns: plain, kernel, kernel, plain
                p1 = cuda_time_ms(lambda: plain(*xb))
                k1 = cuda_time_ms(lambda: kernel(*xb))
                k2 = cuda_time_ms(lambda: kernel(*xb))
                p2 = cuda_time_ms(lambda: plain(*xb))
                served_ms = cuda_time_ms(lambda: served(*xb)) if served else None
                unfused_ms = cuda_time_ms(lambda: unfused(*xb)) if unfused else None
                unfused_dev_ms = device_time_ms(lambda: unfused(*xb)) if unfused else None
                dev_ms = (device_time_ms(lambda: kernel(*xb), info['device_kernel'],
                                         info.get('device_kernels', 1))
                          if 'device_kernel' in info else None)
            lib_ms = cuda_time_ms(lambda: library(*xb)) if library else None
            # every device kernel the library call launches
            lib_dev_ms = (device_time_ms(lambda: library(*xb))
                          if library and 'device_kernel' in info else None)
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            bound_ops, bound_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
            bound = max(bound_ops, bound_bytes)
            bounds = [max(2 * e, 1e-3) for e in errs_p]
            good = same and all(e <= b for e, b in zip(errs_k, bounds))
            ok &= good
            worst = max(worst, *errs_k)
            # serving launches the flash forward without the LSE
            trained = counts['training'] + counts['video_training']
            totals['ms'] += (count * ms if served_ms is None else
                             (count - trained) * served_ms + trained * ms)
            totals['plain_ms'] += count * plain_ms
            totals['operations'] += count * bound_ops if bound_ops >= bound_bytes else 0.
            totals['bytes'] += count * bound_bytes if bound_bytes > bound_ops else 0.
            if lib_ms is not None:
                lib_total = (lib_total or 0.) + count * lib_ms
            if lib_dev_ms is not None:
                totals['library_device_ms'] += count * lib_dev_ms
            if unfused_ms is not None:
                totals['unfused_route_ms'] += count * unfused_ms
                totals['unfused_route_device_ms'] += count * unfused_dev_ms
            if dev_ms is not None:
                totals['device_ms'] += count * dev_ms
            fmt = ', '.join(f'{e:.3e}' for e in errs_k)
            fmt_p = ', '.join(f'{e:.3e}' for e in errs_p)
            served_note = '' if served_ms is None else f' ({served_ms:.4f} ms as served)'
            unfused_note = ('' if unfused_ms is None else
                            f', the unfused route {unfused_ms:.4f} ms (device '
                            f'{unfused_dev_ms:.4f} ms'
                            + (f', {unfused_dev_ms / dev_ms:.2f}x the kernel\'s)' if dev_ms else ')'))
            if dev_ms is not None:
                share = f'{bound / dev_ms:.1%}' if dev_ms > 0 else 'n/a'
                served_note += f' (device {dev_ms:.4f} ms, {share} of the bound)'
            log(f'{name} {dims} x{count} {dict(counts)}: max_abs_err kernel [{fmt}] '
                f'plain-bf16 [{fmt_p}]{"" if same else ", a second call differs"} -> '
                f'{"ok" if good else "FAIL"}; {ms:.4f} ms'
                f'{served_note} vs plain {plain_ms:.4f} ms{unfused_note}, '
                f'library {"n/a" if lib_ms is None else f"{lib_ms:.4f} ms"}'
                f'{"" if lib_dev_ms is None else f" (device {lib_dev_ms:.4f} ms)"}, bound '
                f'{bound:.4f} ms by '
                f'{"operations" if bound_ops >= bound_bytes else "bytes"} '
                f'({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB)')
            free_cuda()
        launches = {path: c.get(name, 0) for path, c in results['counts'].items()}
        summary.append(dict(
            name=name, route='cuda', source=info['source'], replaces=info['replaces'],
            launches=sum(launches.values()), launches_by_path=launches,
            on_path=name not in UNWIRED, max_abs_err=worst,
            ms=totals['ms'], plain_ms=totals['plain_ms'],
            bound_ms=totals['operations'] + totals['bytes'],
            bound_by='operations' if totals['operations'] >= totals['bytes'] else 'bytes',
            library_ms=lib_total))
        for key in ('unfused_route_ms', 'unfused_route_device_ms', 'device_ms',
                    'library_device_ms'):
            if key in totals:
                summary[-1][key] = totals[key]
        if name in UNWIRED:   # times and bounds weighted by these site counts
            summary[-1]['sites'] = {path: sum(sites[name].values())
                                    for path, sites in results['sites'].items() if name in sites}
    results['kernels'] = summary
    return ok


# --- small nets on both paths ----------------------------------------------------------

GATES = ('blocks.conv2d_same_available', 'blocks.fused_feedforward_available',
         'blocks.fused_film_available', 'blocks.stem_available',
         'attention.flash_attention_available', 'video_blocks.flash_attention_available',
         'video_blocks.grouped_temporal_available', 'video_blocks.temporal_layout_available')


@contextmanager
def open_or_closed(is_open, *names):
    """With `is_open` false, the named kernel gates (of `GATES`, by the name
    after the module) closed, so the nets take those sites' plain PyTorch
    path; with it true, nothing changed."""
    from imagen_tpu_torch.models import blocks, video_blocks
    import imagen_tpu_torch.ops.attention as attention
    modules = dict(blocks=blocks, video_blocks=video_blocks, attention=attention)
    gates = [g.split('.') for g in GATES if g.split('.')[1] in names]
    saved = [] if is_open else [(modules[m], n, getattr(modules[m], n)) for m, n in gates]
    try:
        for m, n, _ in saved:
            setattr(m, n, lambda *a, **k: False)
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def plain_path():
    """Every kernel gate closed: the nets run their plain PyTorch path."""
    return open_or_closed(False, *{g.split('.')[1] for g in GATES})


def held_to_fp32(torch, label, ref, fast, x, t, emb, kernels):
    """`fast` (bf16) on its kernel path and on the plain path, outputs and
    parameter gradients, both measured against `ref` (the same net in fp32);
    the kernel path must reach every kernel in `kernels`."""
    from imagen_tpu_torch.ops import _build
    randomize_final_conv(ref, 4)
    fast.load_state_dict(ref.state_dict())
    cot = torch.randn(x.shape, generator=torch.Generator(device='cuda').manual_seed(6),
                      device='cuda')

    def run(unet):
        unet.zero_grad(set_to_none=True)
        out = unet(x, t, text_embeds=emb).float()
        (out * cot).sum().backward()
        return out.detach(), {n: p.grad.float() for n, p in unet.named_parameters()}

    truth, truth_g = run(ref)
    before = dict(_build.LAUNCHES)
    out_k, grads_k = run(fast)
    reached = all(_build.LAUNCHES.get(n, 0) > before.get(n, 0) for n in kernels)
    with plain_path():
        out_p, grads_p = run(fast)

    def grad_err(grads):
        """|g - truth| / |truth| over every parameter gradient as one vector."""
        num = sum(((grads[n] - truth_g[n]) ** 2).sum() for n in truth_g)
        return math.sqrt(float(num) / float(sum((v ** 2).sum() for v in truth_g.values())))

    err_k, err_p = (out_k - truth).abs().max().item(), (out_p - truth).abs().max().item()
    gerr_k, gerr_p = grad_err(grads_k), grad_err(grads_p)
    finite = bool(torch.isfinite(out_k).all()) and all(
        bool(torch.isfinite(v).all()) for v in grads_k.values())
    good = (reached and finite and err_k <= max(2 * err_p, 1e-3)
            and gerr_k <= max(2 * gerr_p, 1e-3))
    log(f'{label} vs fp32: output max_abs_err kernel path {err_k:.3e}, '
        f'plain bf16 path {err_p:.3e} (|truth| max {truth.abs().max().item():.3e}); '
        f'gradient relative error kernel path {gerr_k:.3e}, plain bf16 path {gerr_p:.3e}; '
        f'all kernels reached {reached}, finite {finite} -> {"ok" if good else "FAIL"}')
    return good


def phase_small_unet(torch, it):
    """A small bf16 U-Net with `fused_film=True` that
    reaches every 2D kernel of the paths (128x128 input, 128 channels,
    attention at 64x64, kernel 14 at the stem) and kernel 8 at every Block
    (c 128, 256, 384)."""
    torch.manual_seed(3)
    cfg = dict(dim=128, dim_mults=(1, 2), num_resnet_blocks=1, layer_attns=(False, True),
               layer_cross_attns=(False, True), attn_heads=2, attn_dim_head=64,
               text_embed_dim=64, cond_dim=128, max_text_len=16, attn_pool_num_latents=8,
               fused_film=True)
    g = torch.Generator(device='cuda').manual_seed(5)
    x = torch.randn((2, 128, 128, 3), generator=g, device='cuda')
    t = torch.rand((2,), generator=g, device='cuda')
    emb = torch.randn((2, 16, 64), generator=g, device='cuda')
    return held_to_fp32(torch, 'small unet (b2 128x128, dim 128)', it.Unet(**cfg).eval(),
                        it.Unet(**cfg, dtype=torch.bfloat16).eval(), x, t, emb,
                        [*IMAGE_KERNELS, FILM_KERNEL])


def phase_small_unet3d(torch, it):
    """A small bf16 Unet3D with the fused temporal norms on (8 frames of
    32 px, channels 64 and 128): its temporal sites reach the temporal
    kernel, those at c 128 (the middle and the first up level) kernels 12
    and 13, and `mid_attn` over 8 x 16^2 = 2048 tokens the flash kernels."""
    torch.manual_seed(7)
    cfg = dict(dim=64, dim_mults=(1, 2), num_resnet_blocks=1, layer_attns=False,
               layer_cross_attns=(False, True), attn_heads=4, attn_dim_head=32,
               text_embed_dim=64, cond_dim=64, max_text_len=16, attn_pool_num_latents=8,
               temporal_fused_ln=True)
    g = torch.Generator(device='cuda').manual_seed(8)
    x = torch.randn((2, 8, 32, 32, 3), generator=g, device='cuda')
    t = torch.rand((2,), generator=g, device='cuda')
    emb = torch.randn((2, 16, 64), generator=g, device='cuda')
    return held_to_fp32(torch, 'small Unet3D (b2 8x32x32, dim 64, fused temporal norms)',
                        it.Unet3D(**cfg).eval(),
                        it.Unet3D(**cfg, dtype=torch.bfloat16).eval(), x, t, emb,
                        ['flash_rows_fwd_bf16', 'flash_rows_bwd_bf16', *VIDEO_KERNELS,
                         STEM_KERNEL])


def main():
    try:
        import torch
    except ImportError:
        print('chip_smoke: PyTorch is not installed', file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch.cuda.is_available() is false)', file=sys.stderr)
        return 1
    if not (REPO / 'imagen_tpu_torch' / '__init__.py').exists():
        print(f'chip_smoke: imagen_tpu_torch not found beside {__file__}', file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    # the fp32 truths run in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    device = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
              'count': torch.cuda.device_count()}
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else 'nvidia-smi failed'
    log(card)
    log(f'torch {torch.__version__}, CUDA {torch.version.cuda}')

    ok = True
    results = {'kernels': [], 'counts': {}, 'sites': {},
               'shapes': {path: defaultdict(Counter) for path in PATHS}}
    try:
        import imagen_tpu_torch as it
        from imagen_tpu_torch.ops import _build
        t0 = time.perf_counter()
        _build.library()
        log(f'kernel build: {time.perf_counter() - t0:.1f} s ({_build.BUILD_DIR})')
        ok &= phase_serving(torch, it, _build, results)
        free_cuda()
        ok &= phase_training(torch, it, _build, results)
        free_cuda()
        ok &= phase_video(torch, it, _build, results)
        free_cuda()
        ok &= phase_video_training(torch, it, _build, results)
        free_cuda()
        ok &= phase_edm_serving(torch, it, _build, results)
        free_cuda()
        ok &= phase_sr1024_serving(torch, it, _build, results)
        free_cuda()
        ok &= phase_kernels(torch, results)
        ok &= phase_small_unet(torch, it)
        ok &= phase_small_unet3d(torch, it)
    except Exception:  # a failed phase ends the run with ok: false
        traceback.print_exc(file=sys.stdout)
        ok = False

    log(card)
    log(json.dumps({'kernels': results['kernels']}))
    log(json.dumps({'ok': bool(ok), 'device': device}))
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
