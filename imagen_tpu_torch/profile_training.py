"""Where one training step of the PyTorch port spends device time.

    python -m imagen_tpu_torch.profile_training

For each configuration `chip_smoke.py` trains (unet 1: BaseUnet64 alone at
batch 8; unet 2: NullUnet + SRUnet256 at batch 4; bf16 compute over fp32
parameters, random weights from a seed, Adam with clipping and EMA), takes
3 warm-up steps of `ImagenTrainer.step_with_batch`, times 3 steps
unprofiled, then profiles one under `torch.profiler` (device activity only).
Prints the wall times, the summed device time of the kernels (and so the
device idle share), device time by category and the top kernels. Needs a
GPU; imports no JAX.
"""
import gc
import sys
import time
from collections import defaultdict

import torch

import imagen_tpu_torch as it
from imagen_tpu_torch.profile_serving import category, device_us

CONFIGS = ((1, 8), (2, 4))  # (unet number, batch), as chip_smoke.py trains them


def trainer_for(unet_number):
    common = dict(dtype=torch.bfloat16, text_embed_dim=768, max_text_len=256)
    if unet_number == 1:
        imagen = it.Imagen((it.BaseUnet64(**common),), image_sizes=(64,), cond_drop_prob=0.1)
    else:
        imagen = it.Imagen((it.NullUnet(), it.SRUnet256(**common, lowres_cond=True)),
                           image_sizes=(64, 256), timesteps=(1000, 500), cond_drop_prob=0.1)
    with torch.no_grad():
        imagen.unets[unet_number - 1].final_conv.weight.normal_(0., 0.02)
    return it.ImagenTrainer(imagen, lr=1e-4, max_grad_norm=1.0, ema_update_after_step=0,
                            ema_update_every=1, only_train_unet_number=unet_number,
                            verbose=False)


def profile(unet_number, batch):
    torch.manual_seed(unet_number)
    trainer = trainer_for(unet_number)
    size = trainer.imagen.image_sizes[unet_number - 1]
    g = torch.Generator(device='cuda').manual_seed(1234)
    data = dict(images=torch.rand((batch, size, size, 3), generator=g, device='cuda'),
                text_embeds=torch.randn((batch, 256, 768), generator=g, device='cuda'))

    def step():
        t0 = time.perf_counter()
        trainer.step_with_batch(data, unet_number=unet_number)  # returns a float: syncs
        return (time.perf_counter() - t0) * 1e3

    for _ in range(3):
        step()
    plain_ms = [step() for _ in range(3)]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        wall_ms = step()

    kernels = [e for e in prof.key_averages() if device_us(e) > 0]
    busy_ms = sum(device_us(e) for e in kernels) / 1e3
    print(f'unet {unet_number}, batch {batch}, {size}px: step wall '
          f'{", ".join(f"{ms:.1f}" for ms in plain_ms)} ms unprofiled, {wall_ms:.1f} ms '
          f'profiled; device busy {busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}; '
          f'{sum(e.count for e in kernels)} kernel launches')
    by_cat = defaultdict(float)
    for e in kernels:
        by_cat[category(e.key)] += device_us(e) / 1e3
    for label, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f'  {label:14s} {ms:9.1f} ms  {ms / busy_ms:6.1%}')
    print('top kernels by device time:')
    for e in sorted(kernels, key=device_us, reverse=True)[:15]:
        print(f'  {device_us(e) / 1e3:9.2f} ms  x{e.count:<6d} {e.key[:110]}')


def main():
    if not torch.cuda.is_available():
        sys.exit('needs a CUDA device')
    print(torch.cuda.get_device_name(0))
    for unet_number, batch in CONFIGS:
        profile(unet_number, batch)
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
