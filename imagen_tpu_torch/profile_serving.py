"""Where one request of the PyTorch port's serving path spends device time.

    python -m imagen_tpu_torch.profile_serving            # 64->256 images
    python -m imagen_tpu_torch.profile_serving --edm      # the same cascade, EDM
    python -m imagen_tpu_torch.profile_serving --video    # 16-frame video
    python -m imagen_tpu_torch.profile_serving --sr1024   # 256->1024, SRUnet1024

Builds, on one NVIDIA GPU with bf16 compute and random weights from seed 0,
either paper-preset BaseUnet64 + SRUnet256 with an `ImagenServer` at batch 4
(a request of 4 prompts; with `--edm` an `ElucidatedImagen` whose unets
have `fused_film=True`, at `chip_smoke.py`'s EDM steps), or the `Unet3D` of
`chip_smoke.py`'s video phase (dim 64, mults 1-2-4, 16 frames at 64 px)
with a server at batch 1 (a request of 1 prompt), or (`--sr1024`)
`chip_smoke.py`'s SR-1024 tail, `NullUnet` + `SRUnet1024`, whose request
is `Imagen.sample` from `start_at_unet_number=2` on a 256 px image, batch 1
(the server takes no start image). Warms up, then times one request unprofiled, then one
under `torch.profiler` (device activity only), each inside a recording of the program's
spans and counters (`utils.profiling.recording`). Prints both wall times, the summed device
time of the kernels and the device idle share (1 - busy over the unprofiled request's wall time: the
profiler stretches the host's side of a request, not the device's work), device time by
category (the port's CUDA kernels, cuDNN convs, GEMMs, elementwise, reductions, copies) and
the top kernels by device time; then the profiled request's host self time by span name
(`serve.generate`, `sample`, `sample.step`, `unet.forward`) and its route counters
(`conv3x3`: `kernel` or `cudnn`; `attention`: `flash` or `plain`) by shape, with each
counter's share of work on its kernel route, and its launches of the hand-written kernels;
and the unprofiled request's U-Net forwards by route (`unet_graph`: `replay` of a CUDA graph,
`capture`, `eager`), since a profiler keeps every forward eager, with its kernel launches
issued and replayed from graphs.
Needs a GPU; imports no JAX.
"""
import argparse
import sys
import time
from collections import defaultdict

import torch

import imagen_tpu_torch as it
from imagen_tpu_torch.utils.profiling import recording

STEPS = (16, 8)  # the steps of chip_smoke.py, cut from (1000, 1000) for time
EDM_STEPS = (16, 8)  # chip_smoke.py's EDM steps, cut from edm_paper's (64, 32)
VIDEO_STEPS, VIDEO_FRAMES = 16, 16  # chip_smoke.py's video phase
SR_STEPS = 8  # chip_smoke.py's SR-1024 steps, cut from the JAX bench's 32

CATEGORIES = (
    ('port kernels', ('conv2d_same_3x3', 'flash_rows_', 'fused_feedforward', 'temporal_attn',
                      'ln_relayout', 'film_norm', 'layernorm_rows', 'ln_matmul',
                      'cross_embed_scale', 'conv2d_same_cf', 'radix_select')),
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


def randomize_final_conv(*unets):
    """The final conv starts at zero; random values let every weight reach the output."""
    with torch.no_grad():
        for unet in unets:
            unet.final_conv.weight.normal_(0., 0.02)


def image_server(edm=False):
    common = dict(dtype=torch.bfloat16, text_embed_dim=768, max_text_len=256, fused_film=edm)
    base = it.BaseUnet64(**common)
    sr = it.SRUnet256(**common, lowres_cond=True)
    randomize_final_conv(base, sr)
    if edm:
        imagen = it.ElucidatedImagen((base, sr), image_sizes=(64, 256),
                                     num_sample_steps=EDM_STEPS, cond_drop_prob=0.1).eval()
        label = f'EDM, fused_film, steps {EDM_STEPS} (2N - 1 forwards each)'
    else:
        imagen = it.Imagen((base, sr), image_sizes=(64, 256), timesteps=STEPS,
                           cond_drop_prob=0.1).eval()
        label = f'steps {STEPS}'
    return it.ImagenServer(imagen, batch_size=4, cond_scale=3., seed=0), \
        f'{label}, batch 4 (8 with CFG)'


def video_server():
    unet = it.Unet3D(dim=64, dim_mults=(1, 2, 4), num_resnet_blocks=2, layer_attns=False,
                     layer_cross_attns=(False, True, True), text_embed_dim=768,
                     max_text_len=256, dtype=torch.bfloat16)
    randomize_final_conv(unet)
    imagen = it.Imagen((unet,), image_sizes=(64,), timesteps=VIDEO_STEPS,
                       cond_drop_prob=0.1).eval()
    server = it.ImagenServer(imagen, batch_size=1, video_frames=VIDEO_FRAMES, cond_scale=3.,
                             seed=0)
    return server, (f'video, {VIDEO_FRAMES} frames of 64 px, steps {VIDEO_STEPS}, '
                    'batch 1 (2 with CFG)')


def sr1024_request():
    """`chip_smoke.py`'s SR-1024 request: one prompt, a 256 px start image."""
    sr = it.SRUnet1024(dtype=torch.bfloat16, text_embed_dim=768, max_text_len=256,
                       lowres_cond=True)
    randomize_final_conv(sr)
    imagen = it.Imagen((it.NullUnet(), sr), image_sizes=(256, 1024),
                       timesteps=(2 * SR_STEPS, SR_STEPS), cond_drop_prob=0.1).eval()
    g = torch.Generator(device='cuda').manual_seed(1234)
    emb = torch.randn((1, 256, 768), generator=g, device='cuda')
    start = torch.rand((1, 256, 256, 3), generator=g, device='cuda')

    def request():
        imagen.sample(text_embeds=emb, cond_scale=3., start_at_unet_number=2,
                      start_image_or_video=start)
    request()   # warm-up
    return request, f'SR-1024 tail, steps {SR_STEPS}, batch 1 (2 with CFG)'


def server_request(server, label):
    g = torch.Generator(device='cuda').manual_seed(1234)
    emb = torch.randn((server.batch_size, 256, 768), generator=g, device='cuda')
    return (lambda: server.generate(text_embeds=emb)), label


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument('--video', action='store_true',
                      help='profile the 16-frame text-to-video request')
    mode.add_argument('--edm', action='store_true',
                      help='profile the EDM request of the 64->256 cascade with fused_film')
    mode.add_argument('--sr1024', action='store_true',
                      help='profile the SR-1024 request (NullUnet + SRUnet1024)')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit('needs a CUDA device')

    torch.manual_seed(0)
    if args.sr1024:
        request, label = sr1024_request()
    else:
        request, label = server_request(*(video_server() if args.video
                                          else image_server(edm=args.edm)))

    with recording() as plain_rec:
        t0 = time.perf_counter()
        request()
        torch.cuda.synchronize()
        plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with recording() as rec, \
            torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        request()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = [e for e in prof.key_averages() if device_us(e) > 0]
    busy_ms = sum(device_us(e) for e in kernels) / 1e3
    print(f'{torch.cuda.get_device_name(0)}; {label}')
    print(f'request wall {plain_wall_ms:.1f} ms unprofiled, {wall_ms:.1f} ms profiled; '
          f'device busy {busy_ms:.1f} ms, idle share {1 - busy_ms / plain_wall_ms:.3f} '
          '(of the unprofiled request)')
    print('U-Net forwards of the unprofiled request by route (unet_graph): ' + ', '.join(
        f'{route} x{n}' for route, (n, _) in sorted(plain_rec.routes('unet_graph').items()))
        + f'; {plain_rec.share("unet_graph", "replay") or 0.:.1f}% of rows replayed '
        f'(the profiled request runs eagerly); hand-written kernel launches '
        f'{sum(plain_rec.launches.values())} issued, {sum(plain_rec.replayed.values())} '
        'replayed from graphs')
    by_cat = defaultdict(float)
    for e in kernels:
        by_cat[category(e.key)] += device_us(e) / 1e3
    for label, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f'  {label:14s} {ms:9.1f} ms  {ms / busy_ms:6.1%}')
    print('top kernels by device time:')
    for e in sorted(kernels, key=device_us, reverse=True)[:25]:
        print(f'  {device_us(e) / 1e3:9.2f} ms  x{e.count:<6d} {e.key[:110]}')
    print_recording(rec)


def print_recording(rec):
    """The profiled request's host self time by span name, its route counters
    by shape with each counter's share of work on its kernel route, and its
    launches of the hand-written kernels."""
    names = {s.id: s.name for s in rec.spans}
    own, calls = defaultdict(float), defaultdict(int)
    for sid, ns in rec.self_ns().items():
        own[names[sid]] += ns / 1e6
        calls[names[sid]] += 1
    print('host self time by span (profiled request):')
    for name, ms in sorted(own.items(), key=lambda kv: -kv[1]):
        print(f'  {name:16s} x{calls[name]:<5d} {ms:9.1f} ms')
    print('routes by shape (calls, work / 1e9: operations; elements for threshold):')
    for (name, route, key), (n, work) in sorted(rec.counters.items(), key=lambda kv: -kv[1][1]):
        print(f'  {name:10s} {route:7s} {str(key):44s} x{n:<5d} {work / 1e9:10.2f}')
    for name, route in (('conv3x3', 'kernel'), ('attention', 'flash')):
        share = rec.share(name, route)
        if share is not None:
            print(f'{name} work on the {route} route: {share:.1f}%')
    print('launches of the hand-written kernels: ' + ', '.join(
        f'{name} x{n}' for name, n in rec.launches.most_common()))


if __name__ == '__main__':
    main()
