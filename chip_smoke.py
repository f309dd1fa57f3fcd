#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Drives imagen_tpu_torch's paths at full width, with bf16 compute over fp32
parameters and random weights from a seed:
- serving: BaseUnet64 -> SRUnet256, an `ImagenServer` that warms up and
  answers three requests;
- surface: the same cascade built anew; each unet's `forward_with_cond_scale`
  at cond_scale 3 against the free function, bit for bit and launch for
  launch; a `trace` of one guided forward of each unet in `annotate` spans,
  whose file must name the spans and kernels 1, 6, 10 and 14;
  `StepTimer.measure` of one guided forward; then `force_unconditional_`
  and a sample at steps (4, 2), bit for bit the sample of a cascade built
  with `condition_on_text=False` from the same weights and seed;
- inpainting: the same cascade built anew, an `ImagenServer` warmed at
  cond_scales (3, 5) with a per-server `lowres_sample_noise_level`; then,
  batch 4 (8 with CFG), cond_scale 3: a plain `Imagen.sample` request, two
  inpainting requests (a seeded 256 px image, its left half known,
  RESAMPLE_TIMES RePaint resamples a step), one from `init_images` with
  half of each stage's steps skipped, one with `return_all_unet_outputs`
  and a per-call `lowres_sample_noise_level`, and two server requests, at
  cond_scale 5 and at the server's default;
- self_cond: BaseUnet64 with `self_cond=True, cond_images_channels=3`, one
  64 px stage, batch 4, guided, seeded uint8 cond images; its stem takes 9
  channels, past the stem gate, so kernel 14 must not launch there;
- training: `ImagenTrainer.step_with_batch` for 3 steps of each of the two
  configurations the JAX bench trains, unet 1 (BaseUnet64 alone, batch 8)
  and unet 2 (NullUnet + SRUnet256 with the low-res conditioning loss,
  batch 4), with Adam, clipping and EMA;
- video: the `Unet3D` of the JAX bench's video mode (dim 64, mults 1-2-4,
  16 frames at 64 px), an `ImagenServer(video_frames=16)` that warms up and
  answers three requests of one prompt; then (path video_inpainting) one
  `inpaint_videos` request with one (b, h, w) mask for every frame;
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
  each with kernel 14 on and off (its gate closed); then (path
  edm_inpainting) one inpainting request with 2 RePaint resamples a step,
  from `init_images` with half of each stage's steps skipped;
- EDM training: `ElucidatedImagen.forward` through `ImagenTrainer` for 3
  steps each of `edm_paper`'s BaseUnet64 (`fused_film=True`, batch 8, 64
  px, Adafactor; its optimiser state's bytes beside Adam's 2 x fp32
  params) and NullUnet + SRUnet256 (`fused_film=True`, the low-res
  augmentation, batch 4, 256 px, Adam); kernel 8's launches are held to
  forward hooks that count the fused norm calls;
- video EDM: `ElucidatedImagen` over the video `Unet3D`, 16 churn + Heun
  steps (31 forwards), an `ImagenServer(video_frames=16)` that warms up
  and answers three requests of one prompt at cond_scale 3, then one
  `inpaint_videos` request with one (b, h, w) mask and 2 RePaint
  resamples a step, the known pixels checked;
- video EDM training: that `ElucidatedImagen` over the `Unet3D` with
  `temporal_fused_ln=True`, 3 steps on batch 4 clips of 16 frames at 64
  px with Adam, then one step on batch 4 still images (`ignore_time`,
  counted on its own as path video_edm_training_stills), where the
  temporal kernel and kernels 12 and 13 must not launch;
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
  kernel 6 in it;
- train_loop: the trainer as a user runs it, built from a config by
  `ImagenTrainerConfig(...).create()`: NullUnet + SRUnet256 (published
  kwargs, 64 -> 256) with Adafactor, EMA and bf16 compute, fed by
  `add_train_dataset` over 32 seeded 256 px JPEGs written here and read
  through the port's `data.Dataset`, each with a mock T5 embedding, a
  quarter split off for validation, batch 4: 4 `train_step`s with
  `max_batch_size=2`, one `valid_step`, one `step_with_dl_iter` on an
  iterator of this script's own, a checkpoint every 2 steps into a folder
  under build/ that keeps the newest (and one more at the end, which must
  then be the folder's only file); a second trainer from the same config
  resumes from the folder and must hold the same step counts, unet 2 and
  EMA weights and optimiser state, bit for bit; then
  `load_imagen_from_checkpoint(newest, load_ema_if_available=True)` samples
  256 px from a 64 px batch of 2 at SR_STEPS steps, cond_scale 3 (path
  train_loop_sampling). In both parts kernels 14, 6 and 10 are held to
  forward-hook counts, and the flash pair to the hooks' count of the
  attention calls its gate admits: none, since SRUnet256's attention runs
  at 16^2 (256 tokens, under the gate's 1024, as in JAX). The folder is
  removed at the end.
- unet_options: BaseUnet64 (published kwargs) and SRUnet256's published
  widths with linear attention and linear cross-attention at its 64^2 and
  32^2 levels, full cross-attention at 16^2 and the cross-embed downsample
  (the SR_CFG pattern of the JAX parity test), an `Imagen` at
  `resize_mode='linear'`, SR_STEPS steps a stage: a warm-up and two
  requests of batch 2 (4 with CFG) at cond_scale 3 with `use_tqdm`; the
  device time of one `LinearAttention` call at each of its shapes and of
  the 'linear' and nearest resizes of the 64 px batch to 256; then
  (unet_options_training) NullUnet + that SR unet, `step_with_batch` on
  batch 4 at 256 px with Adam, 3 steps at each of remat False, True and
  'save_convs' from the same weights and data, each step's loss, time,
  peak memory and what the forward leaves for the backward, then a step's
  device time; the peak required to fall under remat, what is left for the
  backward to order True < 'save_convs' < False, and 'save_convs' to launch
  the conv kernel no more often than False (no conv recomputed); then
  (unet_options_video) the video `Unet3D` with linear attention, linear
  cross-attention, the cross-embed downsample and remat in an
  `ElucidatedImagen` at `resize_mode='linear'` with
  `resize_cond_video_frames=False`: one step on 2 clips of 16 frames given
  at 128 px, one request of 16 frames after 4 prompt frames. In all three
  kernels 14, 6, 10, the flash pair and the temporal kernel are held to
  forward-hook counts (which fire again, as the kernels launch again, in
  remat's recompute), and the stride-2 cross-embed downsample calls are
  counted: kernel 14 never takes one.
- parallel: the trainer on several GPUs, as two ranks on the one card.
  NullUnet + SRUnet256 at its published widths, bf16 compute, Adam at lr
  1e-5, batch 4 at 256 px: the one-process trainer takes 3 steps and
  samples; then two worker processes (this script with `--parallel-worker`,
  gloo over a FileStore, killed after PARALLEL_WORKER_TIMEOUT s) take, each
  on its 2 rows, 2 steps of data parallelism and of ZeRO-1, 3 of FSDP and,
  with `data=1, model=2` on all 4 rows, 2, each held to the one-process run
  (losses rtol 2e-4; 4096 elements strided over every weight and EMA
  tensor rtol 1e-3 atol 5e-4, and their change from the start within
  PARALLEL_CHANGE_RTOL of the one process's in norm). FSDP saves a sharded
  checkpoint after step 2, which it loads after step 3 to take step 3
  again as it did; then its default bundle, which this process
  loads into a one-process trainer bit for bit, and a sample of batch 1
  held to the one-process sample. Each rank's kernels 6, 10 and 14 are held
  to forward-hook counts, at inputs of the rank's rows; the bytes of
  parameters, optimiser state and EMA per rank (FSDP's and ZeRO-1's about
  half of data parallelism's). Then a one-rank NCCL group takes a data
  parallel and an FSDP step.
Every path's cross-embed stem runs kernel 14: its gate admits the stem of
every U-Net above.
The launch counts are set to 0 just before each path and read just after,
the launches the wrappers issued apart from those that CUDA graph replays
of the U-Net forwards ran (`models/unet_graphs.py`); each path checks that
the kernels it must run ran. A launch's shape is kept through the
program's counters, which a graph's capture keeps on its tape and each
replay counts again, so a replayed launch has its shape too.
Then it holds each hand-written kernel, at every shape the paths launched
it at (kernels 9, 11 and 7 at every recorded site shape; kernel 7 also at
the (2, 1024, 1024, 128) -> 3 shape that the JAX gate admits, kernel
10 at the Perceiver's batch 2 and 4 and on its staged route at (8192, 384,
768) and (288, 1024, 1024), and kernel 11 past the k + n <= 6144 that its
first design took, LN -> matmul at (8192, 256, 8192) and matmul -> LN on its
staged route at (1024, 256, 8192), logged and weighted by nothing), against its plain
PyTorch version, and a small bf16 U-Net and a small bf16 Unet3D that reach
every kernel of the paths against the same nets on the plain path, outputs
and gradients, both measured against fp32.

Prints, in order: the card (nvidia-smi name and power limit) and CUDA
version; the kernel build time; after each of the phases before the
kernel phase, its wall time; per request latency, shape, finiteness and
range; for surface, each unet's equality with the free function and its
launches beside the free function's and the hooks', the trace's size,
spans and kernels' CUDA functions, the timed forward against its CUDA
events, and the forced sample's latency, shape, range and equality; for each request of the inpainting, self_cond, video_inpainting and
edm_inpainting paths its latency, shapes, finiteness, range, the unet
forwards it made per stage and, for inpainting, the worst difference of
the known pixels from the input (1e-6 or FAIL), then the plain and
inpainting latencies side by side and whether the 9-channel stem stayed
off kernel 14; per training step (DDPM, EDM, video EDM) loss, time and
peak memory; the Adafactor state's bytes; launch counts
per path; per video request latency, shape, finiteness, range and peak
memory; per video training step loss, time and peak memory; per EDM request latency,
shape, finiteness, range and peak memory, kernel 8's sites per forward, the
sites of kernels 9 and 11, the on/off latencies and output difference;
per SR-1024 request latency, shape, finiteness, range and peak memory, the
forward's FLOPs, kernel 14's and kernel 6's launches against their hook
counts, kernel 7's site, the on/off latencies and output difference, the
profiled requests' device time and kernel 6's share of it; the device time
of the wrapper's weight copy at the (3, 3, 2048, 1024) site;
for train_loop, the free disk, each step's loss, time and peak memory, each
save's file, bytes and seconds, the folder after rotation, the resumed
trainer's build-and-load time and its bit-for-bit checks, one more load's
bytes and seconds, the checkpoint's rebuild time, the sample's latency,
shape and range, the hook counts against the launches, and the loop's wall
time and peak memory; for parallel, per mode and rank the losses against
the one-process run, the weights' and EMA's worst excess over the
tolerance, the rows the kernel sites saw, step times, peak memory, bytes,
launches against hook counts, FSDP's checkpoint sizes and seconds, the
resumed step and the sample's difference, and the NCCL steps;
per-kernel errors, CUDA-event times, device times and bounds at each shape
(with the unfused route's time and device time for kernels 8, 10, 11, 12, 13
and 14, and its factor over the kernel's device time; kernels 7, 10, 11 and
14 also held to the same bits on a second call; a shape whose measurement
raises is logged as failed and the next one measured); the small nets'
errors; then the card again, one JSON line of kernel results and, last,
the result line {"ok": ..., "device": {...}}.

In the kernel line, `launches` is the sum over the paths of the launches
the wrappers issued and `replayed` of those that graph replays ran (split in
`launches_by_path` and `replayed_by_path`); `ms`, `plain_ms`, `library_ms` and
`bound_ms` are per-call times at each launched shape times that shape's
launches and replays in the paths,
summed (for kernels 9, 11 and 7, `on_path` false, times that shape's site
count, `sites`, keyed by the path that recorded them, since they launch
nowhere on a path). `bound_ms` is the
least time the H100 could take for that work, the
larger of its operations at the dense bf16 peak and its bytes (each input
read once, each output written once) at the HBM rate; `bound_by` says which of
the two bounds most of it. `library_ms` times one PyTorch call that computes
the same function (`F.scaled_dot_product_attention`, its backward,
`F.conv2d`, `F.layer_norm` for kernel 9 without the stable division, two
`torch.kthvalue`s over |x| in fp32 for the order statistics (also their plain
version, whose bits they must give, at the paths' rows and the benchmark
cells', `THRESHOLD_CELL_ROWS`); for
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
import importlib
import json
import math
import re
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
TRAIN_LOOP_ITEMS = 32        # train_loop: seeded 256 px JPEGs, a quarter for validation
TRAIN_LOOP_BATCH = 4
TRAIN_LOOP_STEPS = 4         # train_steps, before one valid_step and one step_with_dl_iter
TRAIN_LOOP_EVERY = 2         # checkpoint_every
TRAIN_LOOP_MIN_FREE = 20e9   # disk the checkpoints need (about 7.4 GB each, two at once)
# SRUnet256 at 256 px: its stem, its 3x3 convs, its feedforwards (the flash
# gate admits none of its 256-token attentions)
TRAIN_LOOP_KERNELS = ('cross_embed_stem_bf16', 'conv2d_same_3x3_bf16', 'fused_feedforward_bf16')
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
        replaces='imagen_tpu/ops/fused_norm.py:384', device_kernel=None),
    # None: every CUDA function of the call (the wrapper launches nothing else;
    # matmul -> LN's staged route is the product and the row norm)
    'fused_matmul_ln_bf16': dict(
        source='imagen_tpu_torch/csrc/fused_ln_matmul.cu',
        replaces='imagen_tpu/ops/fused_norm.py:384', device_kernel=None),
    # the input's 8-channel copy and the stem itself (one launch of each a call)
    'cross_embed_stem_bf16': dict(
        source='imagen_tpu_torch/csrc/cross_embed_stem.cu',
        replaces='imagen_tpu/ops/stem_conv.py:201', device_kernel='cross_embed_',
        device_kernels=2),
    'conv2d_same_cf_bf16': dict(
        source='imagen_tpu_torch/csrc/conv2d_same_cf.cu',
        replaces='imagen_tpu/ops/conv2d.py:403', device_kernel='conv2d_same_cf_kernel'),
    # dynamic thresholding's order statistics: the scratch's zero fill and the
    # three digit passes (every CUDA function of the call)
    'nonneg_order_stats': dict(
        source='imagen_tpu_torch/csrc/order_stats.cu',
        replaces='imagen_tpu/ops/tensor_utils.py:110', device_kernel=None),
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
# 384-wide 32^2 stage of a default Unet at dim 48 (batch 8) and at k past 512;
# kernel 11 past the k + n <= 6144 of its first design, which the JAX gate
# admits (matmul -> LN there on its staged route: n over 8 x 640)
LOG_ONLY_SHAPES = {CF_KERNEL: ((2, 1024, 1024, 128, 3, 3),),
                   'fused_feedforward_bf16': ((72, 512, 2048, 1e-3), (144, 512, 2048, 1e-3),
                                              (8192, 384, 768, 1e-3), (288, 1024, 1024, 1e-3)),
                   'fused_ln_matmul_bf16': ((8192, 256, 8192, 1e-3),),
                   'fused_matmul_ln_bf16': ((1024, 256, 8192, 1e-3),)}
ORDER_STATS = 'nonneg_order_stats'
# the order-statistics kernel's rows in the benchmark's cells, (b, n), measured and
# logged beside the paths' rows: SR-1024's 3 x 1024^2, the cascade's 8 at 256^2 and 64^2
THRESHOLD_CELL_ROWS = ((1, 3 * 1024 ** 2), (8, 3 * 256 ** 2), (8, 3 * 64 ** 2))
# kernels whose result must be the same bits on a second call
DETERMINISTIC = ('fused_feedforward_bf16', 'cross_embed_stem_bf16', 'fused_ln_matmul_bf16',
                 'fused_matmul_ln_bf16', CF_KERNEL, ORDER_STATS)
# kernels whose result must be the plain version's bits
EXACT = (ORDER_STATS,)
PATHS = ('serving', 'training', 'video', 'video_training', 'edm_serving', 'sr1024_serving',
         'inpainting', 'self_cond', 'edm_inpainting', 'video_inpainting', 'edm_training',
         'video_edm', 'video_edm_training', 'video_edm_training_stills', 'train_loop',
         'train_loop_sampling', 'unet_options', 'unet_options_training',
         'unet_options_video', 'parallel', 'surface')
# unet_options: SRUnet256's published widths with the options of the JAX parity
# test's SR_CFG pattern (tests/test_reference_parity.py:38-46); linear attention
# at its 64^2 and 32^2 levels (memory_efficient downsamples 256 -> 128 first)
SR_OPTIONS = dict(layer_cross_attns=(False, True, True, True),
                  use_linear_attn=(False, True, True, False),
                  use_linear_cross_attn=(False, True, True, False),
                  cross_embed_downsample=True)
REMATS = (False, True, 'save_convs')
OPTIONS_TRAIN_STEPS = 3
OPTIONS_TRAIN_BATCH = 4
OPTIONS_VIDEO_BATCH = 2
OPTIONS_PROMPT_FRAMES = 4
# the launches of the flash forward that also write the LSE the backward reads (those
# made under autograd), by size arguments; `counting_path` keeps them under this key
FLASH_WITH_LSE = 'flash_rows_fwd_bf16 with lse'
RESAMPLE_TIMES = 5           # RePaint resamples a step: the JAX default


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


SHAPES = 'chip_smoke.launch'   # the counter that keeps each launch's shape
SHAPELESS = []                   # blocks whose launches outran their shapes


class Launches(Counter):
    """Kernel launches by name that the wrappers issued, and apart, in
    `replayed`, those that CUDA graph replays ran."""

    def __init__(self, *args, **kwargs):
        self.replayed = Counter()
        super().__init__(*args, **kwargs)

    def update(self, other=(), /, **kwargs):
        super().update(other, **kwargs)
        if isinstance(other, Launches):
            self.replayed.update(other.replayed)

    def ran(self, name):
        return self[name] + self.replayed[name]


def count_shapes(build):
    """Wrap `build.launch`, once, so that each launch counts its size
    arguments (those after the leading pointers) as counter SHAPES: under a
    recording they are kept, under a CUDA graph's capture they go on its tape
    and count again at each replay."""
    import ctypes
    from imagen_tpu_torch.utils.profiling import count
    original = build.launch
    if getattr(original, 'counts_shapes', False):
        return

    def launch(name, *args):
        sig = build.SIGNATURES[name]
        n_ptr = next(i for i, a in enumerate(sig) if a is not ctypes.c_void_p)
        dims = tuple(args[n_ptr:])
        count(SHAPES, name, dims, 1)
        if name == 'flash_rows_fwd_bf16' and args[5] is not None:   # the LSE pointer
            count(SHAPES, FLASH_WITH_LSE, dims, 1)
        return original(name, *args)

    launch.counts_shapes = True
    build.launch = launch


@contextmanager
def counting_path(build, shapes, counts):
    """Set the launch counts to 0, record the size arguments of every launch
    that ran in the block, issued or replayed, into `shapes`, and add the
    block's launches to `counts` (a `Launches`), the replayed ones apart."""
    from imagen_tpu_torch.utils import profiling
    count_shapes(build)
    rec = profiling.active_recording()
    own = rec is None
    if own:
        rec = profiling.start_recording()
    before = {k: v[0] for k, v in rec.counters.items() if k[0] == SHAPES}
    build.reset_launches()
    try:
        yield
    finally:
        if own:
            profiling.stop_recording()
        seen = Counter()
        for key, (calls, _) in list(rec.counters.items()):
            if key[0] == SHAPES and calls > before.get(key, 0):
                shapes[key[1]][key[2]] += calls - before.get(key, 0)
                seen[key[1]] += calls - before.get(key, 0)
        counts.update(build.LAUNCHES)
        counts.replayed.update(build.REPLAYED)
        for name in build.LAUNCHES.keys() | build.REPLAYED.keys():
            ran = build.LAUNCHES[name] + build.REPLAYED[name]
            if seen[name] != ran:
                SHAPELESS.append(name)
                log(f'{name}: {ran} launches ran ({build.LAUNCHES[name]} issued, '
                    f'{build.REPLAYED[name]} replayed) but {seen[name]} shapes were kept: '
                    f'a graph captured without count_shapes -> FAIL')


def check_launched(counts, names, path):
    ok = True
    for name in names:
        c = counts.ran(name)
        ok &= c > 0
        log(f'{path} launches {name}: {c} ({counts[name]} issued, {counts.replayed[name]} '
            f'replayed){"" if c > 0 else " -> FAIL: not on the path"}')
    return ok


def forward_calls(imagen):
    """Forward pre-hooks that count the calls of each unet of `imagen` (a
    guided call, one doubled batch, counts once). Returns (calls, handles)."""
    calls = Counter()
    handles = [u.register_forward_pre_hook(lambda *_, i=i: calls.update([i]))
               for i, u in enumerate(imagen.unets)]
    return calls, handles


def half_mask(torch, b, size):
    """(b, size, size) bool, True over the left half: the known pixels."""
    mask = torch.zeros((b, size, size), dtype=torch.bool, device='cuda')
    mask[:, :, :size // 2] = True
    return mask


def sampled(torch, label, fn, shapes, calls=None, known=None):
    """Run one sampling request `fn` (returning a tensor, or a list of them,
    one per stage) and log its latency, shapes, finiteness and range, the
    unet forwards it made (`calls`, from `forward_calls`) and, given `known`
    (the mask and the input images), the worst difference of the known
    pixels from the input after normalize and unnormalize in fp32, which
    must be 1e-6 or less. Returns (good, latency)."""
    if calls is not None:
        calls.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    lat = time.perf_counter() - t0
    outs = out if isinstance(out, list) else [out]
    got = [tuple(o.shape) for o in outs]
    finite = all(bool(torch.isfinite(o).all()) for o in outs)
    in_range = all(float(o.min()) >= 0. and float(o.max()) <= 1. for o in outs)
    good = got == [tuple(sh) for sh in shapes] and finite and in_range
    note = '' if calls is None else f' forwards {dict(sorted(calls.items()))}'
    if known is not None:
        mask, images = known
        expected = (images.float() * 2. - 1. + 1.) * 0.5
        err = float((outs[-1].float() - expected).abs()[mask.expand(outs[-1].shape[:-1])].max())
        good &= err <= 1e-6
        note += f' known pixels max |out - input| {err:.3e} (<= 1e-6)'
    log(f'{label}: latency {lat:.3f} s shapes {got} finite {finite} in [0,1] {in_range}'
        f'{note} peak allocated {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB '
        f'-> {"ok" if good else "FAIL"}')
    return good, lat


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

    counts = Launches()
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


# --- the public surface: the U-Nets' and the cascade's methods, the profiling helpers --------

SURFACE_STEPS = (4, 2)       # the forced-unconditional sample's timesteps
SURFACE_BATCH = 4
SURFACE_COND_SCALE = 3.
SURFACE_SPAN = 'surface_cfg_forward'
SURFACE_KERNELS = ('flash_rows_fwd_bf16', 'conv2d_same_3x3_bf16', 'fused_feedforward_bf16',
                   STEM_KERNEL)


def surface_cascade(torch, it, condition_on_text=True):
    """BaseUnet64 -> SRUnet256 as `phase_serving` builds them, or built
    without text conditioning (`cond_on_text=False` unets, so the cascade
    keeps them as they are)."""
    bf16 = torch.bfloat16
    text = (dict(text_embed_dim=768, max_text_len=256) if condition_on_text
            else dict(cond_on_text=False, text_embed_dim=None))
    base = it.BaseUnet64(dtype=bf16, **text)
    sr = it.SRUnet256(dtype=bf16, lowres_cond=True, **text)
    return it.Imagen((base, sr), image_sizes=(64, 256), timesteps=SURFACE_STEPS,
                     cond_drop_prob=0.1, condition_on_text=condition_on_text).eval()


def surface_inputs(torch, unet, size, g, emb, mask):
    """A unet's guided-forward inputs at batch SURFACE_BATCH: noise, times,
    the text and, for the SR unet, the noised low-res image and its times."""
    b = SURFACE_BATCH
    x = torch.randn((b, size, size, 3), generator=g, device='cuda')
    times = torch.rand((b,), generator=g, device='cuda')
    kw = dict(text_embeds=emb, text_mask=mask)
    if unet.lowres_cond:
        lowres = torch.rand((b, size, size, 3), generator=g, device='cuda') * 2 - 1
        kw.update(lowres_cond_img=lowres,
                  lowres_noise_times=torch.rand((b,), generator=g, device='cuda'))
    return x, times, kw


def trace_names(logdir):
    """The event names and the CUDA kernels' names of the trace `trace`
    wrote into `logdir` (one Chrome trace file)."""
    files = sorted(logdir.glob('*.pt.trace.json'))
    if len(files) != 1:
        raise RuntimeError(f'expected one trace file in {logdir}, found {files}')
    events = json.loads(files[0].read_text())['traceEvents']
    names = {e.get('name', '') for e in events}
    kernels = {e['name'] for e in events if e.get('cat') == 'kernel'}
    return names, kernels, files[0].stat().st_size


def phase_surface(torch, it, build, results):
    """The methods that close the port's public surface, at full width
    (`surface_cascade`: BaseUnet64 -> SRUnet256, bf16 over fp32 seeded
    weights, batch 4, text embeds 256 x 768), counted as path surface:
    - each unet's `forward_with_cond_scale` at cond_scale 3 (one doubled
      batch of 8) against the free `unet_forward_with_cond_scale`, bit for
      bit; the method's launches of kernels 1, 6, 10 and 14 against the
      free function's (counted apart, not on the path) and against forward
      hooks that count the calls each gate admits;
    - `trace(logdir)` around one guided forward of each unet, each inside
      its own `annotate` span: the trace file must name both spans and the
      CUDA functions of kernels 1, 6, 10 and 14, each of which the hooks
      must have counted there (BaseUnet64 holds the flash and feedforward
      sites, SRUnet256 the conv's; both stems take kernel 14);
    - `StepTimer.measure('cuda')` around one guided forward: its time must
      cover the CUDA events' time of the forward inside it (synchronised);
    - `force_unconditional_()`, then a 64 -> 256 sample at SURFACE_STEPS,
      batch 4, cond_scale 3, from a seeded generator: finite, in [0, 1], of
      shape (4, 256, 256, 3), and bit for bit the sample of a cascade built
      with `condition_on_text=False` that loaded the same weights
      non-strictly, from the same seed (its launches counted apart)."""
    import shutil
    from imagen_tpu_torch.diffusion.imagen import unet_forward_with_cond_scale
    from imagen_tpu_torch.utils.profiling import StepTimer, annotate, trace
    t0 = time.perf_counter()
    torch.manual_seed(0)
    imagen = surface_cascade(torch, it)
    for i, unet in enumerate(imagen.unets):
        randomize_final_conv(unet, 1 + i)
    torch.cuda.synchronize()
    log(f'surface: cascade built in {time.perf_counter() - t0:.1f} s')
    g = torch.Generator(device='cuda').manual_seed(4321)
    emb, mask = text_batch(torch, g, SURFACE_BATCH)
    shapes, counts, ok = results['shapes']['surface'], Launches(), True

    for i, (unet, size) in enumerate(zip(imagen.unets, imagen.image_sizes)):
        x, times, kw = surface_inputs(torch, unet, size, g, emb, mask)
        calls, handles = train_loop_hooks(unet)
        mine = Launches()
        with torch.no_grad(), counting_path(build, shapes, mine):
            out = unet.forward_with_cond_scale(x, times, cond_scale=SURFACE_COND_SCALE, **kw)
        for h in handles:
            h.remove()
        free_counts = Launches()
        with torch.no_grad(), counting_path(build, defaultdict(Counter), free_counts):
            free = unet_forward_with_cond_scale(unet, x, times, cond_scale=SURFACE_COND_SCALE,
                                                **kw)
        torch.cuda.synchronize()
        same = torch.equal(out, free)
        launches = {k: (mine.ran(k), free_counts.ran(k), calls[k]) for k in SURFACE_KERNELS}
        good = same and all(a == b == c for a, b, c in launches.values()) and \
            tuple(out.shape) == tuple(x.shape) and bool(torch.isfinite(out).all())
        ok &= good
        log(f'surface: unet {i + 1} forward_with_cond_scale {tuple(out.shape)} equals the free '
            f'function bit for bit {same}; launches (method, free function, hooks) {launches} '
            f'-> {"ok" if good else "FAIL"}')
        counts.update(mine)

    inputs = [surface_inputs(torch, unet, size, g, emb, mask)
              for unet, size in zip(imagen.unets, imagen.image_sizes)]
    spans = [f'{SURFACE_SPAN}_unet{i + 1}' for i in range(len(imagen.unets))]
    logdir = REPO / 'build' / 'surface_trace'
    shutil.rmtree(logdir, ignore_errors=True)
    hooked = [train_loop_hooks(unet) for unet in imagen.unets]
    with torch.no_grad(), counting_path(build, shapes, counts):
        with trace(logdir):
            for unet, span, (x, times, kw) in zip(imagen.unets, spans, inputs):
                with annotate(span):
                    unet.forward_with_cond_scale(x, times, cond_scale=SURFACE_COND_SCALE, **kw)
            torch.cuda.synchronize()
    calls = Counter()
    for unet_calls, handles in hooked:
        calls.update(unet_calls)
        for h in handles:
            h.remove()
    names, kernels, size = trace_names(logdir)
    shutil.rmtree(logdir, ignore_errors=True)
    found = {k: sorted({m.group(0) for n in kernels for m in
                        [re.search(r'\w*' + KERNEL_INFO[k]['device_kernel'] + r'\w*', n)] if m})
             for k in SURFACE_KERNELS}
    good = all(span in names for span in spans) and \
        all(calls[k] > 0 and found[k] for k in SURFACE_KERNELS)
    ok &= good
    log(f'surface: trace of one guided forward of each unet, {size} bytes, {len(kernels)} '
        f'CUDA kernel names; spans {spans} present {[span in names for span in spans]}; the '
        f'kernels the hooks counted ({dict((k, calls[k]) for k in SURFACE_KERNELS)}) by CUDA '
        f'function: {found} -> {"ok" if good else "FAIL"}')

    base, (x, times, kw) = imagen.unets[0], inputs[0]
    timer = StepTimer()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.no_grad(), counting_path(build, shapes, counts):
        with timer.measure('cuda'):
            start.record()
            base.forward_with_cond_scale(x, times, cond_scale=SURFACE_COND_SCALE, **kw)
            end.record()
    wall_ms, event_ms = timer.times[-1] * 1e3, start.elapsed_time(end)
    good = end.query() and wall_ms >= event_ms
    ok &= good
    log(f'surface: StepTimer.measure of one guided BaseUnet64 forward {wall_ms:.2f} ms, the '
        f'CUDA events inside it {event_ms:.2f} ms -> {"ok" if good else "FAIL"}')

    imagen.force_unconditional_()
    forced = (not imagen.condition_on_text and imagen.unconditional
              and not any(u.cond_on_text for u in imagen.unets))
    ok &= forced
    shape = (SURFACE_BATCH, imagen.image_sizes[-1], imagen.image_sizes[-1], 3)

    def sample(cascade):
        return cascade.sample(batch_size=SURFACE_BATCH, cond_scale=SURFACE_COND_SCALE,
                              use_tqdm=False,
                              generator=torch.Generator(device='cuda').manual_seed(99))

    sample_counts = Launches()
    with counting_path(build, shapes, sample_counts):
        t1 = time.perf_counter()
        out = sample(imagen)
        torch.cuda.synchronize()
        lat = time.perf_counter() - t1
    counts.update(sample_counts)
    finite = bool(torch.isfinite(out).all())
    in_range = bool(out.min() >= 0. and out.max() <= 1.)
    good = forced and tuple(out.shape) == shape and finite and in_range
    ok &= good
    log(f'surface: after force_unconditional_ (flags cleared {forced}), a sample at timesteps '
        f'{SURFACE_STEPS}: latency {lat:.3f} s shape {tuple(out.shape)} finite {finite} in [0,1] '
        f'{in_range} -> {"ok" if good else "FAIL"}')

    t1 = time.perf_counter()
    plain = surface_cascade(torch, it, condition_on_text=False)
    loaded = plain.load_state_dict(imagen.state_dict(), strict=False)
    plain_counts = Launches()
    with counting_path(build, defaultdict(Counter), plain_counts):
        same = sample(plain)
    torch.cuda.synchronize()
    equal = torch.equal(out, same)
    same_launches = all(plain_counts.ran(k) == sample_counts.ran(k) for k in SURFACE_KERNELS)
    good = equal and same_launches and not loaded.missing_keys and bool(loaded.unexpected_keys)
    ok &= good
    log(f'surface: a cascade built with condition_on_text=False ({time.perf_counter() - t1:.1f} '
        f's to build, load and sample), {len(loaded.unexpected_keys)} text weights of the '
        f'forced one not loaded, {len(loaded.missing_keys)} missing; its sample equals the '
        f'forced one bit for bit {equal}; launches (forced, built so) '
        f'{dict((k, (sample_counts.ran(k), plain_counts.ran(k))) for k in SURFACE_KERNELS)} '
        f'-> {"ok" if good else "FAIL"}')
    del plain
    ok &= check_launched(counts, SURFACE_KERNELS, 'surface')
    results['counts']['surface'] = counts
    return ok


# --- inpainting, init images and the server's keywords ------------------------------------

def phase_inpainting(torch, it, build, results):
    """BaseUnet64 -> SRUnet256 as `phase_serving` builds it, an `ImagenServer`
    warmed at cond_scales (3, 5) with a per-server low-res noise level; then,
    at TIMESTEPS, batch 4, cond_scale 3: a plain `Imagen.sample` request,
    two inpainting requests (a seeded 256 px image, the left half known,
    RESAMPLE_TIMES RePaint resamples a step), one from `init_images` with
    half of each stage's steps skipped, one with `return_all_unet_outputs`
    and a per-call `lowres_sample_noise_level`, and two server requests, at
    cond_scale 5 and at the server's default."""
    bf16 = torch.bfloat16
    torch.manual_seed(70)
    t0 = time.perf_counter()
    base = it.BaseUnet64(dtype=bf16, text_embed_dim=768, max_text_len=256)
    sr = it.SRUnet256(dtype=bf16, text_embed_dim=768, max_text_len=256, lowres_cond=True)
    randomize_final_conv(base, 71)
    randomize_final_conv(sr, 72)
    imagen = it.Imagen((base, sr), image_sizes=(64, 256), timesteps=TIMESTEPS,
                       cond_drop_prob=0.1).eval()
    server = it.ImagenServer(imagen, batch_size=4, cond_scale=3., cond_scales=(3., 5.),
                             lowres_sample_noise_level=0.3, seed=0)
    log(f'inpainting: cascade built and server warmed at cond_scales {server.cond_scales} in '
        f'{time.perf_counter() - t0:.1f} s (timesteps {TIMESTEPS}, batch 4, R '
        f'{RESAMPLE_TIMES}, server lowres_sample_noise_level 0.3)')

    g = torch.Generator(device='cuda').manual_seed(7070)
    emb, mask = text_batch(torch, g, 4)
    images = torch.rand((4, 256, 256, 3), generator=g, device='cuda')
    known = half_mask(torch, 4, 256)
    final = [(4, 256, 256, 3)]

    def sample(**kw):
        return imagen.sample(text_embeds=emb, text_masks=mask, cond_scale=3.,
                             generator=torch.Generator(device='cuda').manual_seed(71), **kw)

    counts = Launches()
    calls, handles = forward_calls(imagen)
    ok = True
    lats = defaultdict(list)
    try:
        with counting_path(build, results['shapes']['inpainting'], counts):
            good, lat = sampled(torch, 'inpainting: plain request', sample, final, calls)
            ok &= good
            lats['plain'].append(lat)
            for i in range(2):
                good, lat = sampled(
                    torch, f'inpainting request {i}',
                    lambda: sample(inpaint_images=images, inpaint_masks=known,
                                   inpaint_resample_times=RESAMPLE_TIMES),
                    final, calls, known=(known, images))
                ok &= good
                lats['inpaint'].append(lat)
            skip = tuple(n // 2 for n in TIMESTEPS)
            ok &= sampled(torch, f'inpainting: init_images, skip_steps {skip}',
                          lambda: sample(init_images=images, skip_steps=skip), final, calls)[0]
            ok &= sampled(torch, 'inpainting: return_all_unet_outputs, '
                          'lowres_sample_noise_level 0.1',
                          lambda: sample(return_all_unet_outputs=True,
                                         lowres_sample_noise_level=0.1),
                          [(4, 64, 64, 3), (4, 256, 256, 3)], calls)[0]
            for scale in (5., None):
                ok &= sampled(torch, f'inpainting: server request at cond_scale '
                              f'{scale or server.cond_scale} (server lowres level 0.3)',
                              lambda: torch.from_numpy(server.generate(
                                  text_embeds=emb, text_masks=mask, cond_scale=scale)),
                              final, calls)[0]
    finally:
        for h in handles:
            h.remove()
    ok &= check_launched(counts, ['flash_rows_fwd_bf16', 'conv2d_same_3x3_bf16',
                                  'fused_feedforward_bf16', STEM_KERNEL], 'inpainting')
    log(f'inpainting: plain request {[round(v, 3) for v in lats["plain"]]} s, inpainting '
        f'requests {[round(v, 3) for v in lats["inpaint"]]} s (R {RESAMPLE_TIMES})')
    results['counts']['inpainting'] = counts
    return ok


def phase_self_cond(torch, it, build, results):
    """BaseUnet64 at full width with `self_cond=True, cond_images_channels=3`
    (9 input channels, past the stem gate's 8: the stem runs cuDNN's
    convs, as in JAX), one 64 px stage at TIMESTEPS[0] steps, batch 4,
    cond_scale 3, seeded uint8 cond images; a warm-up, then one request."""
    from imagen_tpu_torch.ops.stem_conv import stem_available
    torch.manual_seed(80)
    t0 = time.perf_counter()
    base = it.BaseUnet64(dtype=torch.bfloat16, text_embed_dim=768, max_text_len=256,
                         self_cond=True, cond_images_channels=3)
    randomize_final_conv(base, 81)
    imagen = it.Imagen((base,), image_sizes=(64,), timesteps=TIMESTEPS[0],
                       cond_drop_prob=0.1).eval()
    stem_in = (8, 64, 64, 9)
    log(f'self_cond: BaseUnet64 (self_cond, cond_images_channels 3) built in '
        f'{time.perf_counter() - t0:.1f} s; the stem takes {stem_in}, stem gate '
        f'{stem_available(stem_in, base.init_conv.kernel_sizes)}')
    g = torch.Generator(device='cuda').manual_seed(8080)
    emb, mask = text_batch(torch, g, 4)
    cond = torch.randint(0, 256, (4, 64, 64, 3), generator=g, device='cuda').to(torch.uint8)

    def sample():
        return imagen.sample(text_embeds=emb, text_masks=mask, cond_images=cond, cond_scale=3.,
                             generator=torch.Generator(device='cuda').manual_seed(81))

    ok = sampled(torch, 'self_cond warm-up', sample, [(4, 64, 64, 3)])[0]
    counts = Launches()
    calls, handles = forward_calls(imagen)
    try:
        with counting_path(build, results['shapes']['self_cond'], counts):
            ok &= sampled(torch, 'self_cond request', sample, [(4, 64, 64, 3)], calls)[0]
    finally:
        for h in handles:
            h.remove()
    ok &= check_launched(counts, ['flash_rows_fwd_bf16', 'conv2d_same_3x3_bf16',
                                  'fused_feedforward_bf16'], 'self_cond')
    unfused = counts.ran(STEM_KERNEL) == 0
    ok &= unfused
    log(f'self_cond: {STEM_KERNEL} launches {counts.ran(STEM_KERNEL)}: the stem ran the unfused '
        f'route (9 input channels, gate c * 16 <= 128) -> {"ok" if unfused else "FAIL"}')
    results['counts']['self_cond'] = counts
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
                       unet_number, data, t0)[0]


def train_steps(torch, it, build, shapes, counts, label, imagen, unet_number, data, t0,
                optimizer='adam'):
    """TRAIN_STEPS steps of `ImagenTrainer.step_with_batch` on `data`, with
    the launches counted into `counts`; checks finite losses, a finite
    gradient for every parameter, and that the weights and the EMA moved.
    Returns (ok, the trainer)."""
    unet = imagen.unets[unet_number - 1]
    trainer = it.ImagenTrainer(imagen, lr=1e-4, max_grad_norm=1.0, use_ema=True,
                               ema_update_after_step=0, ema_update_every=1,
                               only_train_unet_number=unet_number, optimizer=optimizer,
                               seed=0, verbose=False)
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
    return ok and grads_ok and changed, trainer


def phase_training(torch, it, build, results):
    ok = True
    counts = Launches()
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
    counts = Launches()
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
    per_step = counts.ran('temporal_attn_fwd_bf16') == expected
    ok &= per_step
    log(f'video: temporal kernel launches {counts.ran("temporal_attn_fwd_bf16")}, expected '
        f'{VIDEO_TEMPORAL_SITES} per step x {VIDEO_STEPS} steps x {len(requests)} requests = '
        f'{expected} -> {"ok" if per_step else "FAIL"}')
    results['counts']['video'] = counts

    # one inpainting request: a seeded clip, one (b, h, w) mask for every frame
    emb, mask = requests[0]
    clip = torch.rand((1, VIDEO_FRAMES, 64, 64, 3), generator=g, device='cuda')
    known = half_mask(torch, 1, 64)
    counts = Launches()
    calls, handles = forward_calls(imagen)
    try:
        with counting_path(build, results['shapes']['video_inpainting'], counts):
            ok &= sampled(
                torch, f'video inpainting request (R {RESAMPLE_TIMES})',
                lambda: imagen.sample(text_embeds=emb, text_masks=mask, cond_scale=3.,
                                      inpaint_videos=clip, inpaint_masks=known,
                                      inpaint_resample_times=RESAMPLE_TIMES,
                                      generator=torch.Generator(device='cuda').manual_seed(31)),
                [(1, VIDEO_FRAMES, 64, 64, 3)], calls, known=(known[:, None], clip))[0]
    finally:
        for h in handles:
            h.remove()
    ok &= check_launched(counts, ['temporal_attn_fwd_bf16'], 'video_inpainting')
    results['counts']['video_inpainting'] = counts
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
    counts = Launches()
    calls, handles = fused_site_calls(unet)
    try:
        ok = train_steps(torch, it, build, results['shapes']['video_training'], counts, label,
                         imagen, 1, data, t0)[0]
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
    counts = Launches()
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
    exact = counts.ran(FILM_KERNEL) == expected > 0 and all(
        film_calls[i] % (forwards[i] * len(requests)) == 0 for i in range(2))
    ok &= exact
    log(f'edm_serving: {FILM_KERNEL} launches {counts.ran(FILM_KERNEL)}, expected {expected} = '
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
        with eager_forwards():
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

    # one inpainting request, 2 RePaint resamples a step, from init images with
    # half of each stage's steps skipped, kernel 8 on
    for unet in imagen.unets:
        film_norms(unet, True)
    images = torch.rand((4, 256, 256, 3), generator=g, device='cuda')
    init = torch.rand((4, 256, 256, 3), generator=g, device='cuda')
    known = half_mask(torch, 4, 256)
    skip = tuple(n // 2 for n in EDM_STEPS)
    counts = Launches()
    calls, handles = forward_calls(imagen)
    try:
        with counting_path(build, results['shapes']['edm_inpainting'], counts):
            ok &= sampled(
                torch, f'edm inpainting request (R 2, init_images, skip_steps {skip})',
                lambda: imagen.sample(text_embeds=emb, text_masks=mask, cond_scale=3.,
                                      inpaint_images=images, inpaint_masks=known,
                                      inpaint_resample_times=2, init_images=init,
                                      skip_steps=skip,
                                      generator=torch.Generator(device='cuda').manual_seed(53)),
                [(4, 256, 256, 3)], calls, known=(known, images))[0]
    finally:
        for h in handles:
            h.remove()
    ok &= check_launched(counts, [FILM_KERNEL, 'flash_rows_fwd_bf16', 'conv2d_same_3x3_bf16',
                                  'fused_feedforward_bf16', STEM_KERNEL], 'edm_inpainting')
    results['counts']['edm_inpainting'] = counts
    return ok


# --- EDM training -----------------------------------------------------------------------

def optimizer_state_bytes(torch, optimizer):
    """Bytes of every tensor the optimiser keeps."""
    return sum(t.numel() * t.element_size() for state in optimizer.state.values()
               for t in state.values() if torch.is_tensor(t))


def phase_edm_training(torch, it, build, results):
    """`ElucidatedImagen.forward` trained through `ImagenTrainer` at paper
    widths with `fused_film=True` (kernel 8 at every 2-D Block, now under
    autograd): unet 1, `edm_paper`'s BaseUnet64 at batch 8, 64 px, with
    Adafactor; unet 2, NullUnet + SRUnet256 with the low-res augmentation,
    batch 4, 256 px, with Adam; TRAIN_STEPS steps each. Kernel 8's launches
    are held to forward hooks that count the fused norm calls."""
    common = dict(dtype=torch.bfloat16, text_embed_dim=768, max_text_len=256, fused_film=True)
    counts = Launches()
    ok = True
    for unet_number, batch, optimizer in ((1, 8, 'adafactor'), (2, 4, 'adam')):
        torch.manual_seed(60 + unet_number)
        t0 = time.perf_counter()
        if unet_number == 1:
            unets, sizes = (it.BaseUnet64(**common),), (64,)
        else:
            unets, sizes = (it.NullUnet(), it.SRUnet256(**common, lowres_cond=True)), (64, 256)
        imagen = it.ElucidatedImagen(unets, image_sizes=sizes, cond_drop_prob=0.1)
        randomize_final_conv(imagen.unets[unet_number - 1], 60 + unet_number)
        size = sizes[-1]
        g = torch.Generator(device='cuda').manual_seed(160 + unet_number)
        emb, mask = text_batch(torch, g, batch)
        data = dict(images=torch.rand((batch, size, size, 3), generator=g, device='cuda'),
                    text_embeds=emb, text_masks=mask)
        stages = 'BaseUnet64' if unet_number == 1 else 'NullUnet + SRUnet256'
        label = (f'edm train unet {unet_number} ({stages}, fused_film, batch {batch}, {size}px, '
                 f'{optimizer})')
        film_calls, _, _, handles = site_hooks(imagen)
        before = counts[FILM_KERNEL]
        try:
            good, trainer = train_steps(torch, it, build, results['shapes']['edm_training'],
                                        counts, label, imagen, unet_number, data, t0,
                                        optimizer=optimizer)
        finally:
            for h in handles:
                h.remove()
        launched = counts[FILM_KERNEL] - before
        expected = sum(film_calls.values())
        exact = launched == expected > 0
        log(f'{label}: {FILM_KERNEL} launches {launched}, expected {expected} = the fused norm '
            f'calls the forward hooks counted ({expected // TRAIN_STEPS} a step) -> '
            f'{"ok" if exact else "FAIL"}')
        ok &= good and exact
        if unet_number == 1:
            n_params = sum(p.numel() for p in imagen.unets[0].parameters() if p.requires_grad)
            state = optimizer_state_bytes(torch, trainer.optimizers[0])
            log(f'{label}: optimiser state {state / 2 ** 30:.3f} GiB (Adafactor: bf16 momentum, '
                f'factored second moments), Adam would keep 2 x fp32 params = '
                f'{8 * n_params / 2 ** 30:.3f} GiB ({state / (8 * n_params):.3f} of it)')
        del trainer, imagen
        free_cuda()
    ok &= check_launched(counts, [*IMAGE_KERNELS, FILM_KERNEL], 'edm_training')
    results['counts']['edm_training'] = counts
    return ok


# --- video EDM serving and training -----------------------------------------------------

def phase_video_edm(torch, it, build, results):
    """`ElucidatedImagen` over the video `Unet3D` (16 frames of 64 px),
    VIDEO_STEPS churn + Heun steps (2N - 1 forwards), an
    `ImagenServer(video_frames=16)` that warms up and answers three requests
    of one prompt at cond_scale 3; then one `inpaint_videos` request with
    one (b, h, w) mask for every frame and 2 RePaint resamples a step."""
    torch.manual_seed(70)
    t0 = time.perf_counter()
    unet = video_unet(torch, it)
    randomize_final_conv(unet, 71)
    imagen = it.ElucidatedImagen((unet,), image_sizes=(64,), num_sample_steps=VIDEO_STEPS,
                                 cond_drop_prob=0.1).eval()
    t1 = time.perf_counter()
    server = it.ImagenServer(imagen, batch_size=1, video_frames=VIDEO_FRAMES, cond_scale=3.,
                             seed=0)
    log(f'video_edm: built in {t1 - t0:.1f} s, warmup {time.perf_counter() - t1:.2f} s '
        f'({VIDEO_STEPS} steps, {2 * VIDEO_STEPS - 1} forwards, {VIDEO_FRAMES} frames, '
        f'serving batch 1, cond_scale 3)')
    g = torch.Generator(device='cuda').manual_seed(7071)
    requests = [text_batch(torch, g, 1) for _ in range(3)]
    counts = Launches()
    ok = True
    calls, handles = forward_calls(imagen)
    try:
        with counting_path(build, results['shapes']['video_edm'], counts):
            for i, (emb, mask) in enumerate(requests):
                torch.cuda.reset_peak_memory_stats()
                ok &= sampled(torch, f'video edm request {i}',
                              lambda: torch.from_numpy(server.generate(
                                  text_embeds=emb, text_masks=mask)),
                              [(1, VIDEO_FRAMES, 64, 64, 3)], calls)[0]
        expected = VIDEO_TEMPORAL_SITES * (2 * VIDEO_STEPS - 1) * len(requests)
        exact = counts.ran('temporal_attn_fwd_bf16') == expected
        ok &= exact
        log(f'video_edm: temporal kernel launches {counts.ran("temporal_attn_fwd_bf16")}, expected '
            f'{VIDEO_TEMPORAL_SITES} per forward x {2 * VIDEO_STEPS - 1} forwards x '
            f'{len(requests)} requests = {expected} -> {"ok" if exact else "FAIL"}')
        emb, mask = requests[0]
        clip = torch.rand((1, VIDEO_FRAMES, 64, 64, 3), generator=g, device='cuda')
        known = half_mask(torch, 1, 64)
        with counting_path(build, results['shapes']['video_edm'], counts):
            ok &= sampled(
                torch, 'video edm inpainting request (R 2)',
                lambda: imagen.sample(text_embeds=emb, text_masks=mask, cond_scale=3.,
                                      inpaint_videos=clip, inpaint_masks=known,
                                      inpaint_resample_times=2,
                                      generator=torch.Generator(device='cuda').manual_seed(72)),
                [(1, VIDEO_FRAMES, 64, 64, 3)], calls, known=(known[:, None], clip))[0]
    finally:
        for h in handles:
            h.remove()
    ok &= check_launched(counts, ['temporal_attn_fwd_bf16', 'flash_rows_fwd_bf16', STEM_KERNEL],
                         'video_edm')
    results['counts']['video_edm'] = counts
    return ok


def phase_video_edm_training(torch, it, build, results):
    """`ElucidatedImagen` over the video `Unet3D` with its fused temporal
    norms on (`temporal_fused_ln=True`), TRAIN_STEPS steps on batch 4 clips
    of 16 frames at 64 px with Adam; then one step on batch 4 still images
    (one-frame clips with `ignore_time`), whose launches are counted on
    their own: the temporal kernel and kernels 12 and 13 must not launch."""
    torch.manual_seed(80)
    t0 = time.perf_counter()
    unet = video_unet(torch, it, temporal_fused_ln=True)
    randomize_final_conv(unet, 81)
    imagen = it.ElucidatedImagen((unet,), image_sizes=(64,), cond_drop_prob=0.1)
    g = torch.Generator(device='cuda').manual_seed(180)
    emb, mask = text_batch(torch, g, VIDEO_TRAIN_BATCH)
    data = dict(images=torch.rand((VIDEO_TRAIN_BATCH, VIDEO_FRAMES, 64, 64, 3), generator=g,
                                  device='cuda'),
                text_embeds=emb, text_masks=mask)
    label = (f'video edm train (Unet3D, batch {VIDEO_TRAIN_BATCH} x {VIDEO_FRAMES} frames, '
             f'64px)')
    counts = Launches()
    calls, handles = fused_site_calls(unet)
    try:
        ok, trainer = train_steps(torch, it, build, results['shapes']['video_edm_training'],
                                  counts, label, imagen, 1, data, t0)
    finally:
        for h in handles:
            h.remove()
    ok &= check_launched(counts, ['flash_rows_fwd_bf16', 'flash_rows_bwd_bf16', *VIDEO_KERNELS,
                                  STEM_KERNEL], 'video_edm_training')
    expected = sum(calls.values())
    for name in ('ln_transpose_bf16', 'norm_untranspose_bf16'):
        exact = counts[name] == expected > 0
        ok &= exact
        log(f'video_edm_training: {name} launches {counts[name]}, expected {expected} fused '
            f'sites over {TRAIN_STEPS} steps -> {"ok" if exact else "FAIL"}')
    results['counts']['video_edm_training'] = counts

    stills = dict(images=torch.rand((VIDEO_TRAIN_BATCH, 64, 64, 3), generator=g, device='cuda'),
                  text_embeds=emb, text_masks=mask)
    counts = Launches()
    with counting_path(build, results['shapes']['video_edm_training_stills'], counts):
        torch.cuda.reset_peak_memory_stats()
        loss = trainer.step_with_batch(stills, unet_number=1)
    good = (math.isfinite(loss) and counts[STEM_KERNEL] > 0
            and all(counts[name] == 0 for name in VIDEO_KERNELS))
    ok &= good
    log(f'video edm train, one step on {VIDEO_TRAIN_BATCH} still images (ignore_time): loss '
        f'{loss:.6f} step time {trainer.step_timer.times[-1]:.4f} s peak allocated '
        f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches '
        f'{dict(sorted(counts.items()))}; temporal kernel and kernels 12/13 at 0 '
        f'-> {"ok" if good else "FAIL"}')
    results['counts']['video_edm_training_stills'] = counts
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

    counts = Launches()
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
        exact = counts.ran(name) == calls[name] > 0
        ok &= exact
        log(f'sr1024_serving: {name} launches {counts.ran(name)}, hook count {calls[name]} '
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


# --- the training loop: data, validation, checkpoint folders, resume, sampling -----------

def sr256_config():
    """SRUnet256's published kwargs (`imagen_tpu/models/unet2d.py:544-555`) as a
    config dict, with the Unet defaults that `UnetConfig` would otherwise
    change (attention heads and head width) written out."""
    return dict(dim=128, dim_mults=[1, 2, 4, 8], num_resnet_blocks=[2, 4, 8, 8],
                layer_attns=[False, False, False, True],
                layer_cross_attns=[False, False, False, True], attn_heads=8, attn_dim_head=64,
                ff_mult=2., memory_efficient=True, text_embed_dim=768, max_text_len=256)


def train_loop_config(folder):
    """The trainer config of the train_loop path: NullUnet + SRUnet256 at 64 ->
    256, text-conditioned, training unet 2 with Adafactor, EMA and bf16
    compute, a checkpoint every TRAIN_LOOP_EVERY steps into `folder`, the
    newest one kept, a quarter of the rows split off for validation."""
    return dict(
        imagen=dict(unets=[{'is_null': True}, sr256_config()], image_sizes=[64, 256],
                    timesteps=[2 * SR_STEPS, SR_STEPS], cond_drop_prob=0.1),
        optimizer='adafactor', use_ema=True, precision='bf16', lr=1e-4, max_grad_norm=1.0,
        ema_update_after_step=0, ema_update_every=1, only_train_unet_number=2,
        checkpoint_path=str(folder), checkpoint_every=TRAIN_LOOP_EVERY,
        max_checkpoints_keep=1, split_valid_from_train=True, split_valid_fraction=0.25,
        seed=0, verbose=False)


class ImageTextItems:
    """The JPEG folder read through the port's `data.Dataset`, each image with
    its mock T5 embedding and mask: (image, text_embeds, text_masks)."""

    def __init__(self, images, embeds, masks):
        self.images, self.embeds, self.masks = images, embeds, masks

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], self.embeds[i], self.masks[i]


def write_jpegs(folder, n, size, seed):
    """`n` seeded size x size JPEGs (smooth colour ramps with noise)."""
    import numpy as np
    from PIL import Image
    folder.mkdir(parents=True)
    r = np.random.RandomState(seed)
    ramp = np.linspace(0., 1., size, dtype=np.float32)
    for i in range(n):
        base = r.rand(3).astype(np.float32)
        pixels = (base + 0.5 * ramp[:, None, None] * ramp[None, :, None]
                  + 0.1 * r.rand(size, size, 3)) % 1.
        Image.fromarray((pixels * 255).astype(np.uint8)).save(folder / f'{i:03d}.jpg',
                                                              quality=92)


def differentiated(torch):
    """Whether the forward running now gets a backward pass of its own: a
    gradient is recorded and it is not a remat recompute, which runs inside
    the backward pass (the graph task id is -1 outside one) and whose
    gradients flow through the first forward's graph."""
    return torch.is_grad_enabled() and torch._C._current_graph_task_id() == -1


def train_loop_hooks(unet):
    """Forward pre-hooks on `unet` that count the calls taking kernels 14, 6,
    10 and the flash forward (a stride-1 `CrossEmbedLayer`, a `SameConv3x3`,
    a `FeedForward` and an `Attention` whose gates admit the input), and the
    flash backward (an admitted `Attention` call that is `differentiated`):
    their expected launches, since 14, 6 and 10 launch once a forward and
    their backward runs the plain route. Returns (calls, handles)."""
    from imagen_tpu_torch.models import blocks
    from imagen_tpu_torch.ops.flash_attention import flash_attention_available
    from imagen_tpu_torch.ops.fused_norm import fused_feedforward_available
    import torch
    calls, _, handles = sr1024_hooks(unet)

    def ff_hook(module, args):
        x = args[0]
        dim, hidden = module.dim, module.hidden_dim
        if fused_feedforward_available(x.numel() // dim, dim, hidden, module.compute_dtype,
                                       x.device.type):
            calls['fused_feedforward_bf16'] += 1

    def attn_hook(module, args, kwargs):
        x = args[0]
        if flash_attention_available(x.shape[-2], module.q_scale.shape[0],
                                     kwargs.get('mask') is not None,
                                     kwargs.get('attn_bias') is not None, heads=module.heads,
                                     dtype=module.to_q.compute_dtype,
                                     device_type=x.device.type):
            calls['flash_rows_fwd_bf16'] += 1
            calls['flash_rows_bwd_bf16'] += differentiated(torch)

    for m in unet.modules():
        if isinstance(m, blocks.FeedForward):
            handles.append(m.register_forward_pre_hook(ff_hook))
        elif isinstance(m, blocks.Attention):
            handles.append(m.register_forward_pre_hook(attn_hook, with_kwargs=True))
    return calls, handles


def held_to_hooks(counts, calls, label, kernels=IMAGE_KERNELS):
    """Each kernel's launches against the hooks' count of the calls its gate
    admits (0 where it admits none: then the kernel must not launch)."""
    ok = True
    for name in kernels:
        exact = counts.ran(name) == calls[name]
        ok &= exact
        log(f'{label}: {name} launches {counts.ran(name)}, hook count {calls[name]} '
            f'-> {"ok" if exact else "FAIL"}')
    return ok


def directory_files(folder):
    return sorted(p.name for p in folder.iterdir())


def same_bits(torch, a, b):
    """Whether two (nested) state dicts hold the same tensors, bit for bit, in
    the same dtypes and on the same devices."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_bits(torch, a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_bits(torch, x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
    return a == b


def phase_train_loop(torch, it, build, results):
    """The trainer as a user runs it (`imagen_tpu_torch/trainer.py`): built
    from a config through `ImagenTrainerConfig(...).create()` (NullUnet +
    SRUnet256's published kwargs, 0.732 B parameters, 64 -> 256,
    Adafactor, EMA, bf16), fed by `add_train_dataset` over TRAIN_LOOP_ITEMS
    seeded 256 px JPEGs written here and read through the port's
    `data.Dataset` (PIL on a host without libjpeg), each with a mock T5
    embedding, a quarter split off for validation, batch TRAIN_LOOP_BATCH;
    TRAIN_LOOP_STEPS `train_step`s with `max_batch_size=2` (two chunks a
    step), one `valid_step` and one `step_with_dl_iter` on an iterator of
    this script's own; a checkpoint every TRAIN_LOOP_EVERY steps into a
    folder that keeps the newest one, then one more at the end; a second
    trainer from the same config resumes from the folder and must hold the
    first one's step counts, unet 2 weights, EMA and optimiser state bit for
    bit; `load_imagen_from_checkpoint(newest, load_ema_if_available=True)`
    then samples 256 px from a 64 px batch at SR_STEPS steps with guidance
    (path train_loop_sampling). In both parts every image kernel is held to
    forward-hook counts: 14, 6 and 10 launch; SRUnet256's attention runs at
    16^2, 256 tokens, under the flash gate's 1024 (as in JAX), so the flash
    pair must not."""
    import shutil
    t_loop = time.perf_counter()
    root = REPO / 'build' / 'train_loop'
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    usage = shutil.disk_usage(root)
    log(f'train_loop: disk at {root}: {usage.free / 1e9:.1f} GB free of '
        f'{usage.total / 1e9:.1f} GB')
    if usage.free < TRAIN_LOOP_MIN_FREE:
        raise RuntimeError(f'train_loop needs {TRAIN_LOOP_MIN_FREE / 1e9:.0f} GB of disk for '
                           f'its checkpoints, {usage.free / 1e9:.1f} GB free')
    folder = root / 'checkpoints'
    try:
        return train_loop(torch, it, build, results, root, folder, t_loop)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def train_loop(torch, it, build, results, root, folder, t_loop):
    from imagen_tpu_torch import data, native
    ok = True
    write_jpegs(root / 'images', TRAIN_LOOP_ITEMS, 256, seed=70)
    images = data.Dataset(str(root / 'images'), 256, seed=71)
    g = torch.Generator().manual_seed(72)
    lengths = torch.randint(8, 257, (TRAIN_LOOP_ITEMS,), generator=g)
    masks = torch.arange(256)[None] < lengths[:, None]
    embeds = torch.randn((TRAIN_LOOP_ITEMS, 256, 768), generator=g) * masks[..., None]
    log(f'train_loop: {len(images)} JPEGs of 256 px through data.Dataset '
        f'(native decoder: {native.available()})')

    torch.cuda.reset_peak_memory_stats()
    torch.manual_seed(73)
    t0 = time.perf_counter()
    trainer = it.ImagenTrainerConfig(**train_loop_config(folder)).create()
    unet = trainer.unets[1]
    randomize_final_conv(unet, 74)
    torch.cuda.synchronize()
    log(f'train_loop: ImagenTrainerConfig(...).create(): NullUnet + SRUnet256 '
        f'{sum(p.numel() for p in unet.parameters()) / 1e9:.3f} B params in '
        f'{time.perf_counter() - t0:.1f} s')
    trainer.add_train_dataset(ImageTextItems(images, embeds, masks), batch_size=TRAIN_LOOP_BATCH)
    log(f'train_loop: {len(trainer.train_dl.dataset)} training rows in {len(trainer.train_dl)} '
        f'batches, {len(trainer.valid_dl.dataset)} validation rows')

    saves = []
    save = trainer.save

    def timed_save(path, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(path, *args, **kwargs)
        saves.append((Path(path).name, Path(path).stat().st_size, time.perf_counter() - t0))
        log(f'train_loop save {saves[-1][0]}: {saves[-1][1] / 1e9:.3f} GB in '
            f'{saves[-1][2]:.2f} s; the folder before rotation {directory_files(folder)}')

    trainer.save = timed_save

    counts_train = Launches()
    calls, handles = train_loop_hooks(unet)
    losses = []
    try:
        with counting_path(build, results['shapes']['train_loop'], counts_train):
            for step in range(1, TRAIN_LOOP_STEPS + 1):
                loss = trainer.train_step(unet_number=2, max_batch_size=2)
                losses.append(loss)
                log(f'train_loop train_step {step}: loss {loss:.6f} step time '
                    f'{trainer.step_timer.times[-1]:.4f} s peak allocated '
                    f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB')
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            valid = trainer.valid_step(unet_number=2, max_batch_size=2)
            torch.cuda.synchronize()
            log(f'train_loop valid_step: loss {valid:.6f} in {time.perf_counter() - t0:.3f} s')
            own = iter([tuple(x.cuda() for x in (torch.stack([images[i] for i in range(4)]),
                                                 embeds[:4], masks[:4]))])
            loss = trainer.step_with_dl_iter(own, unet_number=2, max_batch_size=2)
            log(f'train_loop step_with_dl_iter: loss {loss:.6f} step time '
                f'{trainer.step_timer.times[-1]:.4f} s')
            losses += [valid, loss]
    finally:
        for h in handles:
            h.remove()
    finite = all(math.isfinite(x) for x in losses)
    ok &= finite
    log(f'train_loop: losses finite {finite} -> {"ok" if finite else "FAIL"}')
    # SRUnet256's attention runs at 16^2 (memory_efficient downsamples before
    # every stage): 256 tokens, under the flash gate's 1024 in both packages
    ok &= held_to_hooks(counts_train, calls, 'train_loop')
    ok &= check_launched(counts_train, TRAIN_LOOP_KERNELS, 'train_loop')
    results['counts']['train_loop'] = counts_train

    trainer.save_to_checkpoint_folder()
    files = directory_files(folder)
    steps = int(trainer.steps.sum())
    kept = files == [f'checkpoint.{steps}.ckpt']
    ok &= kept
    log(f'train_loop: after rotation the folder holds {files}; expected only '
        f'checkpoint.{steps}.ckpt -> {"ok" if kept else "FAIL"}')

    # a second trainer from the same config resumes from the folder at construction
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resumed = it.ImagenTrainerConfig(**train_loop_config(folder)).create()
    torch.cuda.synchronize()
    log(f'train_loop: the second trainer built and resumed from '
        f'{folder.name}/{files[-1]} ({(folder / files[-1]).stat().st_size / 1e9:.3f} GB) in '
        f'{time.perf_counter() - t0:.2f} s')
    checks = {
        'step counts': resumed.steps.tolist() == trainer.steps.tolist(),
        'unet 2 weights': same_bits(torch, resumed.unets[1].state_dict(), unet.state_dict()),
        'EMA unet 2': same_bits(torch, resumed.ema_unets[1].state_dict(),
                                trainer.ema_unets[1].state_dict()),
        'optimiser state': same_bits(torch, resumed.optimizers[1].state_dict(),
                                     trainer.optimizers[1].state_dict()),
    }
    resumed_ok = all(checks.values())
    ok &= resumed_ok
    log(f'train_loop: resume bit for bit {checks} -> {"ok" if resumed_ok else "FAIL"}')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resumed.load_from_checkpoint_folder()
    torch.cuda.synchronize()
    log(f'train_loop load {files[-1]}: {(folder / files[-1]).stat().st_size / 1e9:.3f} GB in '
        f'{time.perf_counter() - t0:.2f} s (trainer.load, onto the card)')
    del resumed
    trainer.save = save
    del trainer, unet
    free_cuda()

    t0 = time.perf_counter()
    imagen = it.load_imagen_from_checkpoint(str(folder / files[-1]), load_ema_if_available=True)
    imagen.unets[1].set_compute_dtype(torch.bfloat16)
    imagen.eval()
    torch.cuda.synchronize()
    log(f'train_loop: load_imagen_from_checkpoint (EMA weights) in '
        f'{time.perf_counter() - t0:.2f} s')
    g = torch.Generator(device='cuda').manual_seed(75)
    emb, mask = text_batch(torch, g, 2)
    start = torch.rand((2, 64, 64, 3), generator=g, device='cuda')
    counts_sample = Launches()
    calls, handles = train_loop_hooks(imagen.unets[1])
    with counting_path(build, results['shapes']['train_loop_sampling'], counts_sample):
        good, _ = sampled(torch, f'train_loop sample (256 px from 64 px, {SR_STEPS} steps, '
                                 f'cond_scale 3)',
                          lambda: imagen.sample(text_embeds=emb, text_masks=mask, cond_scale=3.,
                                                start_at_unet_number=2,
                                                start_image_or_video=start,
                                                generator=torch.Generator(device='cuda')
                                                .manual_seed(76)),
                          [(2, 256, 256, 3)])
    for h in handles:
        h.remove()
    ok &= good
    ok &= held_to_hooks(counts_sample, calls, 'train_loop_sampling')
    ok &= check_launched(counts_sample, TRAIN_LOOP_KERNELS, 'train_loop_sampling')
    results['counts']['train_loop_sampling'] = counts_sample
    log(f'train_loop: wall time {time.perf_counter() - t_loop:.1f} s, peak allocated '
        f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; saves '
        f'{[(n, round(b / 1e9, 3), round(s, 2)) for n, b, s in saves]}')
    del imagen
    return ok


# --- the remaining U-Net options --------------------------------------------------------

def options_hooks(unet):
    """`train_loop_hooks` (kernels 14, 6, 10 and the 2-D flash pair) plus,
    for a `Unet3D`, a hook on each `VideoAttention` that counts the calls its
    gates send to the flash pair (`mid_attn`) or to the temporal kernel, and
    one on each stride-2 `CrossEmbedLayer` (the cross-embed downsample, whose
    even kernels kernel 14's gate never admits). Under remat the forward
    hooks fire again in the recompute, as the forward kernels launch again
    there; the flash backward is counted on the first forward only
    (`differentiated`), as it runs once."""
    from imagen_tpu_torch.models import blocks, video_blocks
    from imagen_tpu_torch.ops.flash_attention import (
        flash_attention_available, grouped_temporal_available)
    import torch
    calls, handles = train_loop_hooks(unet)

    def video_attn_hook(module, args, kwargs):
        x = args[0]
        n, h, dh, dt = x.shape[-2], module.heads, module.dim_head, module.to_q.compute_dtype
        per_pixel = kwargs.get('context') is None and kwargs.get('mask') is None
        plain = per_pixel and module.rel_pos_bias is None and not module.causal
        if plain and flash_attention_available(n, dh, False, False, heads=h, dtype=dt,
                                               device_type=x.device.type):
            calls['flash_rows_fwd_bf16'] += 1
            calls['flash_rows_bwd_bf16'] += differentiated(torch)
        elif per_pixel and grouped_temporal_available(n, h, n + 1, dh, dt, x.device.type):
            calls['temporal_attn_fwd_bf16'] += 1

    def downsample_hook(module, args):
        if module.stride == 2:
            calls['stride-2 cross-embed calls'] += 1

    for m in unet.modules():
        if isinstance(m, video_blocks.VideoAttention):
            handles.append(m.register_forward_pre_hook(video_attn_hook, with_kwargs=True))
        elif isinstance(m, blocks.CrossEmbedLayer):
            handles.append(m.register_forward_pre_hook(downsample_hook))
    return calls, handles


def downsample_seen(calls, label):
    """Whether the path made a stride-2 cross-embed downsample call, which
    kernel 14 does not take: its launches, held to the stride-1 stem calls
    alone, show that none of them reached it."""
    seen = calls['stride-2 cross-embed calls'] > 0
    log(f'{label}: {calls["stride-2 cross-embed calls"]} stride-2 cross-embed downsample calls, '
        f'none of them on kernel 14 (its launches equal the stride-1 stem calls) '
        f'-> {"ok" if seen else "FAIL"}')
    return seen


def options_sr(torch, it, **kwargs):
    return it.SRUnet256(dtype=torch.bfloat16, text_embed_dim=768, max_text_len=256,
                        lowres_cond=True, **SR_OPTIONS, **kwargs)


def linear_attention_device_times(torch, unet, run):
    """The device time of one `LinearAttention` call (every CUDA function
    it launches) at each input shape `run()` gives the unet's linear
    attentions, in eval mode without a gradient."""
    from imagen_tpu_torch.models.blocks import LinearAttention
    shapes = {}

    def hook(module, args):
        shapes.setdefault(tuple(args[0].shape), module)
    handles = [m.register_forward_pre_hook(hook) for m in unet.modules()
               if isinstance(m, LinearAttention)]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    g = torch.Generator(device='cuda').manual_seed(91)
    times = {}
    with torch.no_grad():
        for shape, module in sorted(shapes.items()):
            x = torch.randn(shape, generator=g, device='cuda').to(torch.bfloat16)
            times[shape] = device_time_ms(lambda: module(x))
    return times


def options_serving(torch, it, build, results):
    """`Imagen(..., resize_mode='linear')` over BaseUnet64 (published kwargs)
    and the options' SRUnet256, 64 -> 256 at SR_STEPS steps a stage: one
    warm-up, then two requests of batch 2 at cond_scale 3 with `use_tqdm`."""
    torch.manual_seed(50)
    t0 = time.perf_counter()
    base = it.BaseUnet64(dtype=torch.bfloat16, text_embed_dim=768, max_text_len=256)
    sr = options_sr(torch, it)
    randomize_final_conv(base, 51)
    randomize_final_conv(sr, 52)
    imagen = it.Imagen((base, sr), image_sizes=(64, 256), timesteps=(SR_STEPS, SR_STEPS),
                       cond_drop_prob=0.1, resize_mode='linear').eval()
    torch.cuda.synchronize()
    log(f'unet_options: BaseUnet64 + SRUnet256 with {SR_OPTIONS}, '
        f'{sum(p.numel() for p in sr.parameters()) / 1e9:.3f} B params in the SR unet, built in '
        f'{time.perf_counter() - t0:.1f} s')
    g = torch.Generator(device='cuda').manual_seed(53)
    requests = [text_batch(torch, g, 2) for _ in range(3)]

    def request(i):
        emb, mask = requests[i]
        return imagen.sample(text_embeds=emb, text_masks=mask, cond_scale=3., use_tqdm=True,
                             generator=torch.Generator(device='cuda').manual_seed(54 + i))

    torch.cuda.reset_peak_memory_stats()
    ok, lat = sampled(torch, 'unet_options warm-up request', lambda: request(0),
                      [(2, 256, 256, 3)])
    counts = Launches()
    calls = Counter()
    handle_sets = [options_hooks(u) for u in imagen.unets]
    try:
        with counting_path(build, results['shapes']['unet_options'], counts):
            for i in (1, 2):
                ok &= sampled(torch, f'unet_options request {i}', lambda: request(i),
                              [(2, 256, 256, 3)])[0]
    finally:
        for c, handles in handle_sets:
            calls.update(c)
            for h in handles:
                h.remove()
    ok &= held_to_hooks(counts, calls, 'unet_options')
    ok &= downsample_seen(calls, 'unet_options')
    ok &= check_launched(counts, ['flash_rows_fwd_bf16', 'conv2d_same_3x3_bf16',
                                  'fused_feedforward_bf16', STEM_KERNEL], 'unet_options')
    results['counts']['unet_options'] = counts

    times = linear_attention_device_times(torch, sr, lambda: request(1))
    for shape, ms in times.items():
        log(f'unet_options: LinearAttention at {shape} (bf16, eval): device {ms:.4f} ms a call')
    from imagen_tpu_torch.ops.tensor_utils import resize_image_to
    low = torch.rand((2, 64, 64, 3), generator=g, device='cuda')
    for method in ('nearest', 'linear'):
        ms = device_time_ms(lambda: resize_image_to(low, 256, method=method))
        log(f'unet_options: resize (2, 64, 64, 3) fp32 -> 256 px, {method}: device {ms:.4f} ms')
    del imagen, base, sr
    return ok


def options_training(torch, it, build, results):
    """NullUnet + the options' SRUnet256 (64 -> 256), `step_with_batch` on
    batch OPTIONS_TRAIN_BATCH at 256 px with Adam for OPTIONS_TRAIN_STEPS
    steps at each remat setting, from the same weights and data: each
    step's loss, time, peak memory and the memory the unet's forward
    leaves for the backward (allocated at its end over the step's start),
    then the device time of a step, from the profiler over 3 steps more.
    Remat must lower the peak; True must leave less for the backward than
    'save_convs', and 'save_convs' less than False; 'save_convs' must
    launch the conv kernel as often as False does (it keeps the convs'
    outputs and recomputes only what comes before them)."""
    g = torch.Generator(device='cuda').manual_seed(60)
    emb, mask = text_batch(torch, g, OPTIONS_TRAIN_BATCH)
    data = dict(images=torch.rand((OPTIONS_TRAIN_BATCH, 256, 256, 3), generator=g,
                                  device='cuda'), text_embeds=emb, text_masks=mask)
    ok, peaks, firsts, later, by_remat, left, busy = True, {}, {}, {}, {}, {}, {}
    counts = Launches()
    for remat in REMATS:
        torch.manual_seed(61)
        imagen = it.Imagen((it.NullUnet(), options_sr(torch, it, remat=remat)),
                           image_sizes=(64, 256), timesteps=(1000, 500), cond_drop_prob=0.1)
        unet = imagen.unets[1]
        randomize_final_conv(unet, 62)
        trainer = it.ImagenTrainer(imagen, lr=1e-4, max_grad_norm=1.0, use_ema=False,
                                   only_train_unet_number=2, optimizer='adam', seed=0,
                                   verbose=False)
        calls, handles = options_hooks(unet)
        ends = []
        handles.append(unet.register_forward_hook(
            lambda *_: ends.append(torch.cuda.memory_allocated() / 2 ** 30)))
        path_counts = Launches()
        losses, step_peaks = [], []
        try:
            with counting_path(build, results['shapes']['unet_options_training'], path_counts):
                for step in range(1, OPTIONS_TRAIN_STEPS + 1):
                    torch.cuda.reset_peak_memory_stats()
                    start = torch.cuda.memory_allocated() / 2 ** 30
                    losses.append(trainer.step_with_batch(data, unet_number=2))
                    step_peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
                    left[remat] = ends[-1] - start
                    log(f'unet_options train remat={remat!r} step {step}: loss '
                        f'{losses[-1]:.6f} step time {trainer.step_timer.times[-1]:.4f} s '
                        f'peak allocated {step_peaks[-1]:.2f} GiB, left for the backward '
                        f'{left[remat]:.3f} GiB')
        finally:
            for h in handles:
                h.remove()
        later[remat] = sum(list(trainer.step_timer.times)[1:]) / (OPTIONS_TRAIN_STEPS - 1)
        busy[remat] = device_time_ms(lambda: trainer.step_with_batch(data, unet_number=2),
                                     iters=2)
        finite = all(math.isfinite(x) for x in losses)
        ok &= finite
        label = f'unet_options_training remat={remat!r}'
        ok &= held_to_hooks(path_counts, calls, label)
        ok &= downsample_seen(calls, label)
        counts.update(path_counts)
        by_remat[remat] = path_counts
        peaks[remat], firsts[remat] = max(step_peaks), losses[0]
        del trainer, imagen, unet
        free_cuda()
    lower = all(peaks[r] < peaks[False] for r in REMATS[1:])
    ok &= lower
    log(f'unet_options_training: peak allocated by remat {peaks}, first-step losses {firsts} '
        f'(the same weights, data and dropout seed); remat lowers the peak '
        f'-> {"ok" if lower else "FAIL"}')
    log(f'unet_options_training: mean step time after the first by remat {later}; device '
        f'time a step (ms, torch.profiler, 2 more steps) {busy}')
    between = left[True] < left['save_convs'] < left[False]
    ok &= between
    log(f'unet_options_training: GiB the forward leaves for the backward by remat {left}; '
        f"True < 'save_convs' < False -> {'ok' if between else 'FAIL'}")
    conv = 'conv2d_same_3x3_bf16'
    kept = by_remat['save_convs'][conv] == by_remat[False][conv]
    ok &= kept
    log(f"unet_options_training: remat='save_convs' launches {conv} "
        f"{by_remat['save_convs'][conv]} times, False {by_remat[False][conv]}, True "
        f"{by_remat[True][conv]}: no conv recomputed -> {'ok' if kept else 'FAIL'}")
    ok &= check_launched(counts, ['conv2d_same_3x3_bf16', 'fused_feedforward_bf16',
                                  STEM_KERNEL], 'unet_options_training')
    results['counts']['unet_options_training'] = counts
    return ok


def options_video(torch, it, build, results):
    """The JAX bench's video `Unet3D` (dim 64, mults 1-2-4) with linear
    attention, linear cross-attention, the cross-embed downsample and
    remat, in an `ElucidatedImagen` with `resize_mode='linear'` and
    `resize_cond_video_frames=False`: one training step on batch 2 clips of
    16 frames given at 128 px (resized to 64 in 'linear'), then one request
    of 16 frames after OPTIONS_PROMPT_FRAMES prompt frames at VIDEO_STEPS
    steps, cond_scale 3. With one stage the prompt frames have no temporal
    factor to skip; the CPU tests hold the flag on a two-stage cascade."""
    torch.manual_seed(64)
    unet = video_unet(torch, it, use_linear_attn=True, use_linear_cross_attn=True,
                      cross_embed_downsample=True, remat=True)
    randomize_final_conv(unet, 65)
    imagen = it.ElucidatedImagen((unet,), image_sizes=(64,), num_sample_steps=VIDEO_STEPS,
                                 cond_drop_prob=0.1, resize_mode='linear',
                                 resize_cond_video_frames=False)
    trainer = it.ImagenTrainer(imagen, lr=1e-4, max_grad_norm=1.0, use_ema=False,
                               optimizer='adam', seed=0, verbose=False)
    g = torch.Generator(device='cuda').manual_seed(66)
    emb, mask = text_batch(torch, g, OPTIONS_VIDEO_BATCH)
    clips = torch.rand((OPTIONS_VIDEO_BATCH, VIDEO_FRAMES, 128, 128, 3), generator=g,
                       device='cuda')
    counts = Launches()
    calls, handles = options_hooks(unet)
    ok = True
    try:
        with counting_path(build, results['shapes']['unet_options_video'], counts):
            torch.cuda.reset_peak_memory_stats()
            loss = trainer.step_with_batch(dict(images=clips, text_embeds=emb, text_masks=mask))
            finite = math.isfinite(loss)
            ok &= finite
            log(f'unet_options video train step (batch {OPTIONS_VIDEO_BATCH} x {VIDEO_FRAMES} '
                f'frames, 128 -> 64 px, remat=True): loss {loss:.6f} step time '
                f'{trainer.step_timer.times[-1]:.4f} s peak allocated '
                f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB -> '
                f'{"ok" if finite else "FAIL"}')
            prompt = torch.rand((1, OPTIONS_PROMPT_FRAMES, 64, 64, 3), generator=g,
                                device='cuda')
            torch.cuda.reset_peak_memory_stats()
            ok &= sampled(torch, f'unet_options video request ({VIDEO_FRAMES} frames after '
                                 f'{OPTIONS_PROMPT_FRAMES} prompt frames)',
                          lambda: imagen.sample(text_embeds=emb[:1], text_masks=mask[:1],
                                                video_frames=VIDEO_FRAMES, cond_scale=3.,
                                                cond_video_frames=prompt, use_tqdm=True,
                                                generator=torch.Generator(device='cuda')
                                                .manual_seed(67)),
                          [(1, VIDEO_FRAMES, 64, 64, 3)])[0]
    finally:
        for h in handles:
            h.remove()
    ok &= held_to_hooks(counts, calls, 'unet_options_video',
                        (*IMAGE_KERNELS, 'temporal_attn_fwd_bf16'))
    ok &= downsample_seen(calls, 'unet_options_video')
    ok &= check_launched(counts, ['temporal_attn_fwd_bf16', 'flash_rows_fwd_bf16',
                                  'flash_rows_bwd_bf16', STEM_KERNEL], 'unet_options_video')
    results['counts']['unet_options_video'] = counts
    del trainer, imagen, unet
    return ok


def phase_unet_options(torch, it, build, results):
    """The U-Net options off the other paths: linear attention and linear
    cross-attention, the cross-embed downsample, remat at each setting,
    `resize_mode='linear'` and `use_tqdm`, in serving, training and video
    (`options_serving`, `options_training`, `options_video`)."""
    ok = options_serving(torch, it, build, results)
    free_cuda()
    ok &= options_training(torch, it, build, results)
    free_cuda()
    return ok & options_video(torch, it, build, results)


# --- each kernel against its plain version --------------------------------------------

# --- several GPUs: data parallelism, ZeRO-1, FSDP and the 'model' axis ----------------------

PARALLEL_BATCH = 4             # the global batch: two rows a rank
PARALLEL_SIZES = (64, 256)     # NullUnet's and SRUnet256's image sizes
PARALLEL_LR = 1e-5             # Adam's lr-sized steps on near-zero gradients bound the drift
PARALLEL_SAMPLE_STEPS = 2      # the SR stage's steps in the sample off the FSDP weights
PARALLEL_SAMPLE_ATOL = 2e-2    # the sample against the one-process one: a few bf16 steps near 1
PARALLEL_WORKER_TIMEOUT = 420  # seconds; a worker past it is killed and the phase fails
PARALLEL_PROBE = 4096          # elements of every tensor held to the one-process run, strided
# a mode's change of the probes from the start against the one-process change: the
# norm of their difference at most this share of the one-process change's norm. Adam
# moves every weight by about lr, so a mode that drops an update or a reduction is off
# by a large share (a planted fault: 0.47-0.88, H100 80GB HBM3 at 700 W), while bf16 at
# a rank's 2 rows against the one process's 4 is off by 0.021-0.029 (the same run; the
# 0.02 that tests/test_torch_train_loop.py holds fp32 on the CPU to is below that)
PARALLEL_CHANGE_RTOL = 0.1
# modes that gloo refuses on CUDA tensors, which then run in the one-rank NCCL group
# instead of on two ranks: none, gloo took every collective of every mode on the card
GLOO_REFUSED = ()
PARALLEL_MODES = (   # (name, mesh (data, model), trainer options, steps)
    ('ddp', (2, 1), {}, 2),
    ('zero1', (2, 1), {'shard_optimizer_states': True}, 2),
    ('fsdp', (2, 1), {'fsdp': True}, 3),
    ('tp', (1, 2), {}, 2),
)
PARALLEL_KERNELS = ('conv2d_same_3x3_bf16', 'fused_feedforward_bf16', STEM_KERNEL)


def parallel_trainer(torch, it, **options):
    """NullUnet + SRUnet256 at its published widths (`sr256_config()`), bf16
    compute over fp32 weights, the same seeded weights on every rank and in
    the one-process run; Adam at PARALLEL_LR with clipping and an EMA every
    step. A process makes one trainer at a time, several in all, so the
    once-a-process lock is released first."""
    torch.manual_seed(80)
    imagen = it.ImagenConfig(unets=[{'is_null': True}, sr256_config()],
                             image_sizes=list(PARALLEL_SIZES),
                             timesteps=[2 * SR_STEPS, PARALLEL_SAMPLE_STEPS],
                             cond_drop_prob=0.1).create()
    randomize_final_conv(imagen.unets[1], 81)
    it.ImagenTrainer.locked = False
    return it.ImagenTrainer(imagen, lr=PARALLEL_LR, max_grad_norm=1.0, use_ema=True,
                            ema_update_after_step=0, ema_update_every=1, precision='bf16',
                            only_train_unet_number=2, seed=0, verbose=False, **options)


def parallel_batch(torch):
    g = torch.Generator(device='cuda').manual_seed(82)
    emb, mask = text_batch(torch, g, PARALLEL_BATCH)
    size = PARALLEL_SIZES[1]
    return dict(images=torch.rand((PARALLEL_BATCH, size, size, 3), generator=g, device='cuda'),
                text_embeds=emb, text_masks=mask)


def parallel_step(trainer, batch, step):
    """Step `step` (from 1) of unet 2. The generator is seeded anew before the
    third, in every run alike, since FSDP's resumed third step takes it too."""
    if step == 3:
        trainer.generator.manual_seed(99)
    return trainer.step_with_batch(dict(batch), unet_number=2)


def parallel_sample(torch, trainer):
    """Batch 1, 256 px from a seeded 64 px image, PARALLEL_SAMPLE_STEPS steps."""
    g = torch.Generator(device='cuda').manual_seed(83)
    emb, mask = text_batch(torch, g, 1)
    size = PARALLEL_SIZES[0]
    start = torch.rand((1, size, size, 3), generator=g, device='cuda')
    return trainer.sample(text_embeds=emb, text_masks=mask, cond_scale=1.,
                          start_at_unet_number=2, start_image_or_video=start, use_tqdm=False,
                          generator=torch.Generator(device='cuda').manual_seed(84))


def probes(state):
    """PARALLEL_PROBE elements of every tensor, on the host, strided over the
    whole of it, so that every rank's block of a cut tensor has its share."""
    def probe(v):
        flat = v.detach().flatten()
        return flat[::max(1, flat.numel() // PARALLEL_PROBE)][:PARALLEL_PROBE].float().cpu()
    return {k: probe(v) for k, v in state.items()}


def held_probes(mine, ref):
    """(worst |a - b| - (5e-4 + 1e-3 |b|) over every probe, ok): the JAX
    tests' weight tolerance, rtol 1e-3 and atol 5e-4."""
    if mine.keys() != ref.keys():
        return float('inf'), False
    worst = max(float(((mine[k] - v).abs() - (5e-4 + 1e-3 * v.abs())).max())
                for k, v in ref.items())
    return worst, worst <= 0.


def held_change(mine, ref, start, lr):
    """(the norm of the difference of the changes from `start` over the norm
    of the one-process change, the one-process change's largest, ok): the
    one-process run must have moved (by over half an Adam step of lr), the
    mode must follow it to PARALLEL_CHANGE_RTOL."""
    if mine.keys() != ref.keys():
        return float('inf'), 0., False
    import torch
    got = torch.cat([(mine[k] - start[k]) for k in start])
    want = torch.cat([(ref[k] - start[k]) for k in start])
    ratio, largest = float((got - want).norm() / want.norm()), float(want.abs().max())
    return ratio, largest, largest > lr / 2 and ratio <= PARALLEL_CHANGE_RTOL


def rows_hooks(unet):
    """Forward pre-hooks counting the rows of every input to the modules where
    kernels 6, 10 and 14 run (`SameConv3x3`, `FeedForward`, `CrossEmbedLayer`)."""
    from imagen_tpu_torch.models import blocks
    rows = Counter()
    handles = [m.register_forward_pre_hook(lambda m, args: rows.update([int(args[0].shape[0])]))
               for m in unet.modules()
               if isinstance(m, (blocks.SameConv3x3, blocks.FeedForward, blocks.CrossEmbedLayer))]
    return rows, handles


def local_bytes(trainer):
    """This rank's bytes of unet 2's parameters, optimiser state and EMA."""
    def size(tensors):
        return sum(t.numel() * t.element_size() for t in tensors if hasattr(t, 'numel'))
    opt = trainer.optimizers[1]
    return dict(params=size(trainer.unets[1].parameters()),
                optim=size(v for s in opt.state.values() for v in s.values()),
                ema=size(trainer.ema_unets[1].parameters()))


def full_probes(trainer, module):
    """Probes of `module`'s full tensors (gathered where the layout cuts them)."""
    layout = trainer.layouts[1]
    return probes(layout.full_state_dict(module) if layout else module.state_dict())


def parallel_worker(rank, folder):
    """One of the two ranks of phase_parallel on the one card (gloo over a
    FileStore in `folder`): every mode of PARALLEL_MODES but GLOO_REFUSED's on
    its rows of the global batch; what it saw goes to `<folder>/rank<rank>.json`
    after each mode."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    import imagen_tpu_torch as it
    from imagen_tpu_torch.ops import _build
    from imagen_tpu_torch.parallel.mesh import create_mesh
    _build.library()
    folder = Path(folder)
    dist.init_process_group('gloo', store=dist.FileStore(str(folder / 'store'), 2), rank=rank,
                            world_size=2)
    ref = torch.load(folder / 'reference.pt')
    batch = parallel_batch(torch)
    out, shapes = {'modes': {}}, defaultdict(Counter)
    for name, (data, model), options, n in PARALLEL_MODES:
        if name in GLOO_REFUSED:
            continue
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mesh = create_mesh(data=data, model=model)
        trainer = parallel_trainer(torch, it, mesh=mesh, **options)
        mine = batch if data == 1 else {k: v[rank * 2:rank * 2 + 2] for k, v in batch.items()}
        calls, handles = train_loop_hooks(trainer.unets[1])
        rows, more = rows_hooks(trainer.unets[1])
        counts, losses, peaks, mode = Launches(), [], [], {}
        for step in range(1, n + 1):
            if name == 'fsdp' and step == 3:
                mode.update(fsdp_save(torch, trainer, folder))
            torch.cuda.reset_peak_memory_stats()
            with counting_path(_build, shapes, counts):
                losses.append(parallel_step(trainer, mine, step))
            peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        for h in handles + more:
            h.remove()
        mode.update(losses=losses, step_s=list(trainer.step_timer.times), rows=dict(rows),
                    counts=dict(counts), calls={k: calls[k] for k in PARALLEL_KERNELS},
                    bytes=local_bytes(trainer), build_and_steps_s=time.perf_counter() - t0,
                    step_peak_gib=max(peaks))
        if name == 'fsdp':   # its load and the step again: not counted
            mode.update(fsdp_resume(torch, trainer, mine, folder))
        final = full_probes(trainer, trainer.unets[1])
        ema = full_probes(trainer, trainer.ema_unets[1])
        mode['weights_err'], mode['weights_ok'] = held_probes(final, ref[f'weights{n}'])
        mode['ema_err'], mode['ema_ok'] = held_probes(ema, ref[f'ema{n}'])
        for kind, got in (('weights', final), ('ema', ema)):
            mode[f'{kind}_change'] = held_change(got, ref[f'{kind}{n}'], ref['weights0'],
                                                 PARALLEL_LR)
        if name == 'fsdp':
            mode.update(fsdp_bundle_and_sample(torch, trainer, folder, ref, final, rank))
        mode['peak_gib'] = torch.cuda.max_memory_allocated() / 2 ** 30
        out['modes'][name] = mode
        out['shapes'] = [[k, list(dims), c] for k, v in shapes.items() for dims, c in v.items()]
        (folder / f'rank{rank}.json').write_text(json.dumps(out))
        del trainer
        free_cuda()
        dist.barrier()
    dist.destroy_process_group()
    return 0


def fsdp_save(torch, trainer, folder):
    """After FSDP's second step: a sharded save (each rank writes its blocks,
    nothing gathered)."""
    out = {}
    sharded = folder / 'fsdp_sharded'
    trainer.checkpoint_backend = 'orbax'
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.save(str(sharded))
    out['sharded_save_s'] = time.perf_counter() - t0
    trainer.checkpoint_backend = None
    out['sharded_files'] = sorted(p.name for p in (sharded / 'arrays').iterdir())
    out['sharded_bytes'] = sum(p.stat().st_size for p in (sharded / 'arrays').iterdir())
    return out


def fsdp_resume(torch, trainer, mine, folder):
    """After FSDP's third step: the trainer loads the sharded checkpoint of
    step 2 (each rank its blocks, in place) and takes the third step again,
    whose loss must be the uninterrupted third's."""
    out = {}
    trainer.checkpoint_backend = 'orbax'
    t0 = time.perf_counter()
    trainer.load(str(folder / 'fsdp_sharded'))
    torch.cuda.synchronize()
    out['sharded_load_s'] = time.perf_counter() - t0
    trainer.checkpoint_backend = None
    out['loaded_steps'] = int(trainer.steps[1])
    out['resumed_loss'] = parallel_step(trainer, mine, 3)
    out['resumed_steps'] = int(trainer.steps[1])
    return out


def fsdp_bundle_and_sample(torch, trainer, folder, ref, final, rank):
    """FSDP's default bundle without optimiser state (every rank gathers, rank
    0 writes it for the parent to load), and a sample off the FSDP weights."""
    out = {}
    t0 = time.perf_counter()
    trainer.save(str(folder / 'fsdp.ckpt'), without_optim_and_sched=True)
    out['bundle_save_s'] = time.perf_counter() - t0
    torch.save(final, folder / f'fsdp_probes{rank}.pt')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sample = parallel_sample(torch, trainer)
    torch.cuda.synchronize()
    out['sample_s'] = time.perf_counter() - t0
    err = float((sample.float().cpu() - ref['sample']).abs().max())
    out['sample_err'], out['sample_ok'] = err, err <= PARALLEL_SAMPLE_ATOL
    return out


def phase_parallel(torch, it, build, results):
    """Path parallel: the trainer on several GPUs (`parallel/`), as two ranks
    on the one card. The one-process trainer first takes 3 steps of NullUnet +
    SRUnet256 (`parallel_trainer`) on the global batch of PARALLEL_BATCH at 256
    px and samples; then two worker processes (this script with
    `--parallel-worker`, gloo over a FileStore, the one backend that takes two
    ranks on one GPU) take each mode of PARALLEL_MODES on two rows each (the
    'model' mode on all four) and are killed after PARALLEL_WORKER_TIMEOUT s:
    the steps of each mode held to the one-process run (losses rtol 2e-4;
    PARALLEL_PROBE elements strided over every weight and EMA tensor rtol
    1e-3, atol 5e-4, and their change from the start by `held_change`);
    FSDP also saves a sharded checkpoint after step 2, loads it after step 3
    and takes step 3 again, which must be the uninterrupted one; then its
    default bundle, which this process loads into a one-process trainer,
    and a sample of batch 1 held to the one-process sample. Each rank's
    launches of kernels 6, 10 and 14 are held to forward hooks, at inputs
    of the rank's rows; per rank, step times, the steps' peak memory and
    the bytes of parameters, optimiser state and EMA (gloo's collectives
    go through the host: these are no scaling numbers). Then a one-rank NCCL
    group, the backend of a machine with several GPUs, takes a step in data
    parallel and FSDP layout (and each mode of GLOO_REFUSED)."""
    import shutil
    folder = REPO / 'build' / 'parallel'
    shutil.rmtree(folder, ignore_errors=True)
    folder.mkdir(parents=True)
    try:
        return run_parallel(torch, it, results, folder)
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def run_parallel(torch, it, results, folder):
    ok = True
    batch = parallel_batch(torch)
    torch.cuda.reset_peak_memory_stats()
    trainer = parallel_trainer(torch, it)
    unet = trainer.unets[1]
    log(f'parallel: NullUnet + SRUnet256 {sum(p.numel() for p in unet.parameters()) / 1e9:.3f} '
        f'B params, global batch {PARALLEL_BATCH} at 256 px, lr {PARALLEL_LR}')
    ref, losses = {'weights0': probes(unet.state_dict())}, []
    for step in range(1, 4):
        losses.append(parallel_step(trainer, batch, step))
        if step >= 2:
            ref[f'weights{step}'] = probes(unet.state_dict())
            ref[f'ema{step}'] = probes(trainer.ema_unets[1].state_dict())
    ref['losses'] = losses
    ref['sample'] = parallel_sample(torch, trainer).float().cpu()
    log(f'parallel one process: losses {losses}, step times '
        f'{[round(s, 4) for s in trainer.step_timer.times]} s, bytes {local_bytes(trainer)}, '
        f'peak allocated {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB')
    torch.save(ref, folder / 'reference.pt')
    del trainer, unet
    free_cuda()

    t0 = time.perf_counter()
    logs = [open(folder / f'worker{r}.log', 'w') for r in (0, 1)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               '--parallel-worker', str(r), str(folder)],
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in (0, 1)]
    try:
        for p in procs:
            p.wait(timeout=max(1., PARALLEL_WORKER_TIMEOUT - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        log(f'parallel: a worker ran past {PARALLEL_WORKER_TIMEOUT} s -> FAIL')
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    log(f'parallel: two workers on the card in {time.perf_counter() - t0:.1f} s, exit codes '
        f'{[p.returncode for p in procs]}')
    ranks = []
    for r, p in enumerate(procs):
        path = folder / f'rank{r}.json'
        ranks.append(json.loads(path.read_text()) if path.exists() else {'modes': {}})
        if p.returncode != 0:
            ok = False
            log(f'parallel worker {r} -> FAIL; the end of its log:\n'
                f'{(folder / f"worker{r}.log").read_text()[-4000:]}')

    counts = Launches()
    for r, out in enumerate(ranks):
        for name, dims, c in out.get('shapes', []):
            results['shapes']['parallel'][name][tuple(dims)] += c
        for name, *_ in PARALLEL_MODES:
            if name in GLOO_REFUSED:
                continue
            mode = out['modes'].get(name)
            if mode is None:
                ok = False
                log(f'parallel {name} rank {r}: no result -> FAIL')
                continue
            ok &= parallel_mode_ok(name, r, mode, ref, counts)
    ok &= parallel_layouts_ok(ranks)
    ok &= fsdp_bundle_ok(torch, it, folder)
    results['counts']['parallel'] = counts
    ok &= check_launched(counts, PARALLEL_KERNELS, 'parallel')
    ok &= parallel_nccl(torch, it, folder, batch, ref)
    return ok


def parallel_mode_ok(name, rank, mode, ref, counts):
    label = f'parallel {name} rank {rank}'
    n = len(mode['losses'])
    losses_ok = all(abs(a - b) <= 2e-4 * abs(b) for a, b in zip(mode['losses'], ref['losses']))
    rows = dict(sorted(mode['rows'].items()))
    local = str(PARALLEL_BATCH if name == 'tp' else PARALLEL_BATCH // 2)
    rows_ok = list(rows) == [local]
    changes_ok = mode['weights_change'][2] and mode['ema_change'][2]
    good = losses_ok and mode['weights_ok'] and mode['ema_ok'] and changes_ok and rows_ok
    log(f'{label}: losses {mode["losses"]} vs one process {ref["losses"][:n]} (rtol 2e-4); '
        f'weights {mode["weights_err"]:.3e}, EMA {mode["ema_err"]:.3e} past rtol 1e-3 + '
        f'atol 5e-4 (<= 0); kernel sites saw rows {rows} (the rank\'s {local}) '
        f'-> {"ok" if good else "FAIL"}')
    for kind in ('weights', 'ema'):
        ratio, largest, _ = mode[f'{kind}_change']
        log(f'{label}: {kind} change from the start against the one process\'s '
            f'(largest {largest:.3e}, > lr / 2): |difference| / |change| {ratio:.3e} '
            f'(<= {PARALLEL_CHANGE_RTOL})')
    log(f'{label}: step times {[round(s, 4) for s in mode["step_s"]]} s, peak allocated in '
        f'the steps {mode["step_peak_gib"]:.2f} GiB (in the mode {mode["peak_gib"]:.2f}), '
        f'bytes {mode["bytes"]}, built and stepped in {mode["build_and_steps_s"]:.1f} s')
    counts.update(mode['counts'])
    good &= held_to_hooks(Launches(mode['counts']), Counter(mode['calls']), label,
                          kernels=PARALLEL_KERNELS)
    if name == 'fsdp':
        resume_ok = (mode['resumed_loss'] == mode['losses'][2] and mode['loaded_steps'] == 2
                     and mode['resumed_steps'] == 3)
        files_ok = '.metadata' in mode['sharded_files']
        good &= resume_ok and files_ok and mode['sample_ok']
        log(f'{label}: sharded save {mode["sharded_bytes"] / 1e9:.3f} GB ({mode["sharded_files"]}) '
            f'in {mode["sharded_save_s"]:.2f} s, load {mode["sharded_load_s"]:.2f} s (at step '
            f'{mode["loaded_steps"]}); the third step again {mode["resumed_loss"]} vs '
            f'uninterrupted {mode["losses"][2]} -> {"ok" if resume_ok and files_ok else "FAIL"}')
        log(f'{label}: default bundle save {mode["bundle_save_s"]:.2f} s; sample '
            f'{mode["sample_s"]:.2f} s, max |sample - one-process sample| '
            f'{mode["sample_err"]:.3e} (<= {PARALLEL_SAMPLE_ATOL}) '
            f'-> {"ok" if mode["sample_ok"] else "FAIL"}')
    return good


def parallel_layouts_ok(ranks):
    """Per rank, FSDP's parameters, optimiser state and EMA and ZeRO-1's
    optimiser state at 0.45-0.6 of data parallelism's."""
    ok = True
    for r, out in enumerate(ranks):
        modes = out['modes']
        if not all(m in modes for m in ('ddp', 'zero1', 'fsdp')):
            continue
        ddp = modes['ddp']['bytes']
        for name, kinds in (('zero1', ('optim',)), ('fsdp', ('params', 'optim', 'ema'))):
            shares = {k: modes[name]['bytes'][k] / ddp[k] for k in kinds}
            good = all(0.45 <= s <= 0.6 for s in shares.values())
            ok &= good
            log(f'parallel {name} rank {r}: bytes against data parallelism '
                f'{ {k: round(s, 4) for k, s in shares.items()} } -> {"ok" if good else "FAIL"}')
    return ok


def fsdp_bundle_ok(torch, it, folder):
    """FSDP's default bundle in a one-process trainer: its weights are the
    FSDP trainer's, bit for bit (on rank 0's probes)."""
    path = folder / 'fsdp.ckpt'
    if not path.exists():
        log('parallel: no FSDP bundle -> FAIL')
        return False
    trainer = parallel_trainer(torch, it)
    t0 = time.perf_counter()
    trainer.load(str(path), only_model=True)
    got = probes(trainer.unets[1].state_dict())
    want = torch.load(folder / 'fsdp_probes0.pt')
    good = got.keys() == want.keys() and all(torch.equal(got[k], v) for k, v in want.items())
    log(f'parallel: FSDP\'s default bundle ({path.stat().st_size / 1e9:.3f} GB) loaded by a '
        f'one-process trainer in {time.perf_counter() - t0:.2f} s, weights bit for bit '
        f'-> {"ok" if good else "FAIL"}')
    del trainer
    free_cuda()
    return good


def parallel_nccl(torch, it, folder, batch, ref):
    """A one-rank NCCL group in this process: a step in data parallel and in
    FSDP layout (and in each mode of GLOO_REFUSED) on the global batch, each
    held to the one-process trainer's first loss."""
    import torch.distributed as dist
    from imagen_tpu_torch.parallel.mesh import create_mesh
    ok = True
    dist.init_process_group('nccl', init_method=f'file://{folder / "nccl_store"}', rank=0,
                            world_size=1)
    try:
        modes = [('ddp', {}), ('fsdp', {'fsdp': True})]
        modes += [(name, opts) for name, _, opts, _ in PARALLEL_MODES if name in GLOO_REFUSED]
        for name, options in modes:
            trainer = parallel_trainer(torch, it, mesh=create_mesh(), **options)
            loss = parallel_step(trainer, batch, 1)
            good = abs(loss - ref['losses'][0]) <= 2e-4 * abs(ref['losses'][0])
            ok &= good
            log(f'parallel nccl {name} (one rank): loss {loss} vs one process '
                f'{ref["losses"][0]} (rtol 2e-4), step time {trainer.step_timer.times[-1]:.4f} s '
                f'-> {"ok" if good else "FAIL"}')
            del trainer
            free_cuda()
    finally:
        dist.destroy_process_group()
    return ok


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
    from imagen_tpu_torch.ops import tensor_utils as tu
    from imagen_tpu_torch.ops.tensor_utils import l2norm
    bf16 = torch.bfloat16
    unfused = None

    def rnd(*shape, scale=1.):
        return torch.randn(shape, generator=g, device='cuda') * scale

    served = None
    if name == ORDER_STATS:
        b, n, lo, is_bf16 = dims[:4]   # then the grid's blocks a row and the scratch words
        inputs = [rnd(b, n, scale=2.5).to(bf16 if is_bf16 else torch.float32)]

        def kernel(x):
            return tu.nonneg_order_stats(x, lo)

        def plain(x):
            return tu.order_stats_reference(x, lo)
        library = plain   # torch.kthvalue, twice
        flops = 0
        nbytes = b * n * inputs[0].element_size() + 8 * b   # one read of the rows
    elif name == fa.KERNEL:
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


def measure_shape(torch, name, info, dims, counts, g, totals, with_lse=0):
    """Error, times and bound of kernel `name` at one shape, each time added
    to `totals` weighted by the shape's count (`with_lse` of the flash
    forward's launches wrote the LSE, the rest are timed as served);
    returns (good, the worst error, the library call's weighted time or
    None)."""
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
    bounds = [0. if name in EXACT else max(2 * e, 1e-3) for e in errs_p]
    good = same and all(e <= b for e, b in zip(errs_k, bounds))
    totals['ms'] += (count * ms if served_ms is None else
                     (count - with_lse) * served_ms + with_lse * ms)
    totals['plain_ms'] += count * plain_ms
    totals['operations'] += count * bound_ops if bound_ops >= bound_bytes else 0.
    totals['bytes'] += count * bound_bytes if bound_bytes > bound_ops else 0.
    if lib_dev_ms is not None:
        totals['library_device_ms'] += count * lib_dev_ms
    if unfused_ms is not None:
        totals['unfused_route_ms'] += count * unfused_ms
        totals['unfused_route_device_ms'] += count * unfused_dev_ms
    if dev_ms is not None:
        totals['device_ms'] += count * dev_ms
    fmt = ', '.join(f'{e:.3e}' for e in errs_k)
    fmt_p = ', '.join(f'{e:.3e}' for e in errs_p)
    served_note = ('' if served_ms is None else
                   f' ({served_ms:.4f} ms as served; {with_lse} of {count} with the LSE)')
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
    return good, max(errs_k), None if lib_ms is None else count * lib_ms


def threshold_cell_dims(torch):
    """The order-statistics kernel's size arguments at `THRESHOLD_CELL_ROWS`, fp32,
    at dynamic thresholding's 0.95, as the wrapper passes them on this card."""
    from imagen_tpu_torch.ops import _build
    from imagen_tpu_torch.ops import tensor_utils as tu
    sms = _build.sm_count(torch.cuda.current_device())
    return tuple((b, n, tu.quantile_position(n, 0.95)[0], 0, tu.order_stats_blocks(b, n, sms),
                  tu.ORDER_STATS_WORDS) for b, n in THRESHOLD_CELL_ROWS)


def phase_kernels(torch, results):
    g = torch.Generator(device='cuda').manual_seed(7)
    ok = True
    summary = []
    log_weight_copy(torch)
    log_only = {**LOG_ONLY_SHAPES, ORDER_STATS: threshold_cell_dims(torch)}
    for name, info in KERNEL_INFO.items():
        worst = 0.
        totals = defaultdict(float)
        lib_total = None
        by_dims, with_lse = defaultdict(Counter), Counter()
        for path, shapes in results['shapes'].items():
            for dims, count in shapes[name].items():
                by_dims[dims][path] += count
            with_lse.update(shapes[FLASH_WITH_LSE])
        for path, sites in results['sites'].items():
            for dims, count in sites.get(name, {}).items():
                by_dims[dims][f'{path} sites'] += count
        for dims in log_only.get(name, ()):
            by_dims[dims]['log only'] += 0
        for dims, counts in sorted(by_dims.items()):
            try:
                good, err, lib = measure_shape(torch, name, info, dims, counts, g, totals,
                                               with_lse[dims])
            except Exception:  # the next shapes are still measured
                traceback.print_exc(file=sys.stdout)
                log(f'{name} {dims}: FAIL, the measurement raised')
                good, err, lib = False, 0., None
            ok &= good
            worst = max(worst, err)
            if lib is not None:
                lib_total = (lib_total or 0.) + lib
            free_cuda()
        launches = {path: c[name] for path, c in results['counts'].items()}
        replayed = {path: c.replayed[name] for path, c in results['counts'].items()}
        summary.append(dict(
            name=name, route='cuda', source=info['source'], replaces=info['replaces'],
            launches=sum(launches.values()), launches_by_path=launches,
            replayed=sum(replayed.values()), replayed_by_path=replayed,
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

# each kernel gate once, in its `imagen_tpu_torch.ops` module: one patch closes every site
GATES = ('conv2d.conv2d_same_available', 'fused_norm.fused_feedforward_available',
         'fused_norm.fused_film_available', 'stem_conv.stem_available',
         'flash_attention.flash_attention_available', 'flash_attention.grouped_temporal_available',
         'temporal_layout.temporal_layout_available')


@contextmanager
def eager_forwards():
    """Every U-Net forward in the block dispatched eagerly, none replayed
    from a CUDA graph (`models/unet_graphs.py`): a global module hook keeps
    them off the graph route, so a gate or module switch made for an A/B
    takes effect at the next call."""
    import torch
    handle = torch.nn.modules.module.register_module_forward_hook(lambda *args: None)
    try:
        yield
    finally:
        handle.remove()


@contextmanager
def open_or_closed(is_open, *names):
    """With `is_open` false, the named kernel gates (of `GATES`, by the name
    after the module) closed, so the nets take those sites' plain PyTorch
    path; with it true, nothing changed. Either way the forwards run
    eagerly (`eager_forwards`), so both sides dispatch alike."""
    gates = [g.split('.') for g in GATES if g.split('.')[1] in names]
    modules = [importlib.import_module(f'imagen_tpu_torch.ops.{m}') for m, _ in gates]
    saved = [] if is_open else [(m, n, getattr(m, n)) for m, (_, n) in zip(modules, gates)]
    try:
        for m, n, _ in saved:
            setattr(m, n, lambda *a, **k: False)
        with eager_forwards():
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
        count_shapes(_build)   # before any capture, so that every replay keeps its shapes
        for phase in (phase_serving, phase_surface, phase_inpainting, phase_self_cond,
                      phase_training, phase_video, phase_video_training, phase_edm_serving,
                      phase_edm_training, phase_video_edm, phase_video_edm_training,
                      phase_sr1024_serving, phase_train_loop, phase_unet_options,
                      phase_parallel):
            t0 = time.perf_counter()
            ok &= phase(torch, it, _build, results)
            free_cuda()
            log(f'{phase.__name__}: {time.perf_counter() - t0:.1f} s of wall time')
        ok &= not SHAPELESS
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
    if sys.argv[1:2] == ['--parallel-worker']:   # one rank of phase_parallel
        sys.exit(parallel_worker(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
