"""Where one request of the PyTorch port's 64->256 serving path spends device time.

    python -m imagen_tpu_torch.profile_serving

Builds paper-preset BaseUnet64 + SRUnet256 (bf16 compute, random weights
from seed 0) on one NVIDIA GPU, warms an `ImagenServer` at batch 4, then
times one request of 4 prompts unprofiled, then one under `torch.profiler`
(device activity only). Prints both wall times, the summed device time of
the kernels (and so the device idle share), device time by category (the
port's CUDA kernels, cuDNN convs, GEMMs, elementwise, reductions, copies)
and the top kernels by device time. Needs a GPU; imports no JAX.
"""
import sys
import time
from collections import defaultdict

import torch

import imagen_tpu_torch as it

STEPS = (16, 8)  # the steps of chip_smoke.py, cut from (1000, 1000) for time

CATEGORIES = (
    ('port kernels', ('conv2d_same_3x3', 'flash_rows_', 'fused_feedforward')),
    ('optimizer', ('multi_tensor', 'adam')),
    ('cuDNN conv', ('conv', 'xmma', 'implicit', 'cudnn', 'winograd')),
    ('GEMM', ('gemm', 'cutlass', 'nvjet', 'cublas')),
    ('copy / cast', ('copy', 'memcpy', 'memset', 'cat', 'pad')),
    ('reduction', ('reduce', 'softmax', 'norm', 'kthvalue', 'sort', 'radix')),
    ('elementwise', ('elementwise', 'vectorized', 'unrolled')),
)


def category(name):
    low = name.lower()
    for label, keys in CATEGORIES:
        if any(k in low for k in keys):
            return label
    return 'other'


def device_us(event):
    return event.self_device_time_total


def main():
    if not torch.cuda.is_available():
        sys.exit('needs a CUDA device')

    torch.manual_seed(0)
    base = it.BaseUnet64(dtype=torch.bfloat16, text_embed_dim=768, max_text_len=256)
    sr = it.SRUnet256(dtype=torch.bfloat16, text_embed_dim=768, max_text_len=256,
                      lowres_cond=True)
    with torch.no_grad():
        for unet in (base, sr):
            unet.final_conv.weight.normal_(0., 0.02)
    imagen = it.Imagen((base, sr), image_sizes=(64, 256), timesteps=STEPS,
                       cond_drop_prob=0.1).eval()
    server = it.ImagenServer(imagen, batch_size=4, cond_scale=3., seed=0)
    g = torch.Generator(device='cuda').manual_seed(1234)
    emb = torch.randn((4, 256, 768), generator=g, device='cuda')

    t0 = time.perf_counter()
    server.generate(text_embeds=emb)
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.generate(text_embeds=emb)
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = [e for e in prof.key_averages() if device_us(e) > 0]
    busy_ms = sum(device_us(e) for e in kernels) / 1e3
    print(f'{torch.cuda.get_device_name(0)}; steps {STEPS}, batch 4 (8 with CFG)')
    print(f'request wall {plain_wall_ms:.1f} ms unprofiled, {wall_ms:.1f} ms profiled; '
          f'device busy {busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}')
    by_cat = defaultdict(float)
    for e in kernels:
        by_cat[category(e.key)] += device_us(e) / 1e3
    for label, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f'  {label:14s} {ms:9.1f} ms  {ms / busy_ms:6.1%}')
    print('top kernels by device time:')
    for e in sorted(kernels, key=device_us, reverse=True)[:25]:
        print(f'  {device_us(e) / 1e3:9.2f} ms  x{e.count:<6d} {e.key[:110]}')


if __name__ == '__main__':
    main()
