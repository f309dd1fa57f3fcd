"""Drives a one-stage video cascade of the port (`imagen_tpu_torch`): a
`Unet3D` served by `ImagenServer` with `video_frames`.

A request is `ImagenServer.generate(text_embeds=..., text_masks=...,
generator=...)`; its clips (n, f, H, W, 3) come back on the host and are
counted frame by frame, (n f, H, W, 3), so `images_per_s` counts frames.
The reference side builds the configuration's `Unet3D` from
`port_bench/reference/unet3d.py` with the same weights and follows each
checked request's recorded steps (`reference.video.follow`) with the same
generator. The warm-up, the checked requests, the states a request keeps
and what outlives the program are `imagen_sample`'s.
"""
from __future__ import annotations

import torch

from port_bench import correctness
from port_bench.reference import numerics, unet3d, video
from port_bench.systems.imagen_sample import (  # noqa: F401  (the adapter's interface)
    System,
    checked,
    findings,
    record_steps,
    settle,
    warm,
    warm_up,
    weights_of,
)


def build(config, mix, device):
    """The program's one-stage video cascade and its server, with the
    configuration's settings; weights come from `load_weights`."""
    import imagen_tpu_torch as it
    (spec,) = config['unets']
    kwargs = {k: tuple(v) if isinstance(v, list) else v for k, v in spec.items() if k != 'unet'}
    unet = it.Unet3D(**kwargs, text_embed_dim=config['text_embed_dim'],
                     max_text_len=config['max_text_len'],
                     dtype=getattr(torch, config['compute_dtype']), device=device)
    imagen = it.Imagen(
        (unet,), image_sizes=tuple(config['image_sizes']), timesteps=tuple(config['timesteps']),
        text_embed_dim=config['text_embed_dim'], cond_drop_prob=config['cond_drop_prob'],
        noise_schedules=config['noise_schedules'],
        dynamic_thresholding=config['dynamic_thresholding'],
        dynamic_thresholding_percentile=config['dynamic_thresholding_percentile'],
        device=device).eval()
    stated = getattr(torch, config['param_dtype'])
    if any(p.dtype != stated for p in imagen.parameters()):
        raise ValueError(f'the cascade does not hold its weights in {stated}')
    server = it.ImagenServer(imagen, batch_size=mix['prompts'], text_len=config['max_text_len'],
                             cond_scale=config['cond_scale'], video_frames=config['frames'],
                             warmup=False)
    system = System(imagen, server, list(imagen.unets), mix, config)
    record_steps(system)
    return system


def load_weights(system, seed, device):
    """The reference's parameters, by name, into the program's `Unet3D`: a
    name that one side has and the other lacks raises."""
    system.unets[0].load_state_dict(weights_of(seed, device)(0, unet3d.specs(system.config)),
                                    strict=True)


def serve(system, request, states=None):
    """One request through the server; its frames (n f, H, W, 3) in [0, 1]
    on the host. A list `states` receives the request's states."""
    system.states = states
    try:
        gen = torch.Generator(device=request['text_embeds'].device).manual_seed(
            request['noise_seed'])
        out = system.server.generate(text_embeds=request['text_embeds'],
                                     text_masks=request['text_masks'], generator=gen)
        return torch.from_numpy(out).reshape(-1, *out.shape[2:])
    finally:
        system.states = None


def reference_unets(config, seed, device):
    numerics.no_tf32()
    return [unet3d.build(config, weights_of(seed, device), device)]


def _sample_kwargs(config, request):
    return dict(frames_per_clip=config['frames'], image_size=config['image_sizes'][0],
                steps=config['timesteps'][0], text_embeds=request['text_embeds'],
                text_masks=request['text_masks'], cond_scale=config['cond_scale'],
                percentile=config['dynamic_thresholding_percentile'])


def _generator(request):
    return torch.Generator(device=request['text_embeds'].device).manual_seed(
        request['noise_seed'])


def follow(unets, config, mix, request, states):
    """`video.follow` of a request's recorded `states` in float32."""
    return video.follow(unets[0], states, generator=_generator(request),
                        **_sample_kwargs(config, request))


def judge(config, mix, seed, device, request_of, found):
    """The numbers of each checked request, the reference following its states."""
    check, kept = found
    unets = reference_unets(config, seed, device)
    readings = []
    for i in check:
        if i not in kept:
            readings.append(dict(correctness.FAILED))
            continue
        frames, states = kept[i]
        readings.append(correctness.numbers(frames, follow(unets, config, mix, request_of(i),
                                                           states)))
    return readings


def control(unets, config, mix, request):
    """The control in the program's place: the reference's own sampler with
    every product in float8; returns (frames on the host, its states on the host)."""
    states = []
    with numerics.precision('fp8'):
        out = video.sample(unets[0], generator=_generator(request), states=states,
                           **_sample_kwargs(config, request))
    return out.cpu(), [[x.cpu() for x in trail] for trail in states]
