"""Where one training step of the PyTorch port spends device time.

    python -m imagen_tpu_torch.profile_training            # the 64->256 cascade
    python -m imagen_tpu_torch.profile_training --video    # the video Unet3D

For each configuration `chip_smoke.py` trains (unet 1: BaseUnet64 alone at
batch 8; unet 2: NullUnet + SRUnet256 at batch 4; or, with `--video`, the
`Unet3D` of its video training path, dim 64, mults 1-2-4, the fused temporal
norms on, batch 4 clips of 16 frames at 64 px; bf16 compute over fp32
parameters, random weights from a seed, Adam with clipping and EMA), takes
3 warm-up steps of `ImagenTrainer.step_with_batch`, times 3 steps
unprofiled, then profiles one under `torch.profiler` (device activity only).
Prints the wall times, the summed device time of the kernels (and so the
device idle share), the kernel launches of the step, device time and
launches by category, the top kernels and the device time per call of each
of the port's kernels. Needs a GPU; imports no JAX.
"""
import argparse
import gc
import sys
import time
from collections import defaultdict

import torch

import imagen_tpu_torch as it
from imagen_tpu_torch.profile_serving import category, device_us

CONFIGS = ((1, 8), (2, 4))  # (unet number, batch), as chip_smoke.py trains them
VIDEO_BATCH, VIDEO_FRAMES = 4, 16  # chip_smoke.py's video training path


def image_imagen(unet_number):
    common = dict(dtype=torch.bfloat16, text_embed_dim=768, max_text_len=256)
    if unet_number == 1:
        return it.Imagen((it.BaseUnet64(**common),), image_sizes=(64,), cond_drop_prob=0.1)
    return it.Imagen((it.NullUnet(), it.SRUnet256(**common, lowres_cond=True)),
                     image_sizes=(64, 256), timesteps=(1000, 500), cond_drop_prob=0.1)


def video_imagen():
    unet = it.Unet3D(dim=64, dim_mults=(1, 2, 4), num_resnet_blocks=2, layer_attns=False,
                     layer_cross_attns=(False, True, True), text_embed_dim=768,
                     max_text_len=256, temporal_fused_ln=True, dtype=torch.bfloat16)
    return it.Imagen((unet,), image_sizes=(64,), cond_drop_prob=0.1)


def profile(label, imagen, unet_number, batch, frames=None):
    with torch.no_grad():
        imagen.unets[unet_number - 1].final_conv.weight.normal_(0., 0.02)
    trainer = it.ImagenTrainer(imagen, lr=1e-4, max_grad_norm=1.0, ema_update_after_step=0,
                               ema_update_every=1, only_train_unet_number=unet_number,
                               verbose=False)
    size = imagen.image_sizes[unet_number - 1]
    shape = (batch, size, size, 3) if frames is None else (batch, frames, size, size, 3)
    g = torch.Generator(device='cuda').manual_seed(1234)
    data = dict(images=torch.rand(shape, generator=g, device='cuda'),
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
    print(f'{label}, batch {batch}, {"" if frames is None else f"{frames} frames of "}'
          f'{size}px: step wall {", ".join(f"{ms:.1f}" for ms in plain_ms)} ms unprofiled, '
          f'{wall_ms:.1f} ms profiled; device busy {busy_ms:.1f} ms, idle share '
          f'{1 - busy_ms / wall_ms:.3f}; {sum(e.count for e in kernels)} kernel launches')
    by_cat, launches = defaultdict(float), defaultdict(int)
    for e in kernels:
        by_cat[category(e.key)] += device_us(e) / 1e3
        launches[category(e.key)] += e.count
    for label_, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f'  {label_:14s} {ms:9.1f} ms  {ms / busy_ms:6.1%}  {launches[label_]:6d} launches')
    print('top kernels by device time:')
    for e in sorted(kernels, key=device_us, reverse=True)[:15]:
        print(f'  {device_us(e) / 1e3:9.2f} ms  x{e.count:<6d} {e.key[:110]}')
    print('the port\'s kernels, device time per call:')
    for e in kernels:
        if category(e.key) == 'port kernels':
            print(f'  {device_us(e) / e.count:9.1f} us  x{e.count:<6d} {e.key[:110]}')


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--video', action='store_true',
                        help='the video Unet3D instead of the 64->256 cascade')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit('needs a CUDA device')
    print(torch.cuda.get_device_name(0))
    if args.video:
        torch.manual_seed(3)
        profile('video Unet3D', video_imagen(), 1, VIDEO_BATCH, VIDEO_FRAMES)
        return
    for unet_number, batch in CONFIGS:
        torch.manual_seed(unet_number)
        profile(f'unet {unet_number}', image_imagen(unet_number), unet_number, batch)
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
