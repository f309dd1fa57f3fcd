"""Drives an `Imagen` cascade of the port (`imagen_tpu_torch`).

A mix's `entry` says which call serves a request: "server" is
`ImagenServer.generate(text_embeds=..., text_masks=..., generator=...)`,
the product path, which returns the images on the host; "sample" is
`Imagen.sample(..., start_at_unet_number=..., start_image_or_video=...)`,
since the server takes no start image, and the images are copied to the
host as the request's answer. The reference side builds the same cascade
from `port_bench/reference/` with the same weights and the same generator.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from port_bench import correctness, weights
from port_bench.reference import build as build_reference, ddpm, numerics, specs


@dataclass
class System:
    imagen: object
    server: object
    unets: list          # the stages' U-Nets, NullUnets left out
    mix: dict
    config: dict
    states: list = None  # a recorded request's: per stage, its initial image and each step's output


def record_steps(system):
    """Wrap the cascade instance's `p_sample` (one ancestral step) so that a
    recorded request keeps its states: per stage the step's first input, then
    each step's output, as the sampler produced them."""
    imagen = system.imagen
    inner = imagen.p_sample
    last = [None]

    def p_sample(unet, x, t, **kwargs):
        out = inner(unet, x, t, **kwargs)
        if system.states is not None:
            if unet is not last[0] or not system.states:
                system.states.append([x.detach().clone()])
            system.states[-1].append(out[0].detach().clone())
        last[0] = unet
        return out

    imagen.p_sample = p_sample


def build(config, mix, device):
    """The program's cascade (and its server for the "server" entry) with
    the configuration's settings; weights come from `load_weights`."""
    import imagen_tpu_torch as it
    dtype = getattr(torch, config['compute_dtype'])
    unets = []
    for index, spec in enumerate(config['unets']):
        if spec['unet'] == 'NullUnet':
            unets.append(it.NullUnet(lowres_cond=index > 0, device=device))
            continue
        kwargs = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in spec.items() if k != 'unet'}
        unets.append(it.Unet(**kwargs, text_embed_dim=config['text_embed_dim'],
                             max_text_len=config['max_text_len'], lowres_cond=index > 0,
                             dtype=dtype, device=device))
    imagen = it.Imagen(
        unets, image_sizes=tuple(config['image_sizes']), timesteps=tuple(config['timesteps']),
        text_embed_dim=config['text_embed_dim'], cond_drop_prob=config['cond_drop_prob'],
        noise_schedules=config['noise_schedules'],
        lowres_noise_schedule=config['lowres_noise_schedule'],
        lowres_sample_noise_level=config['lowres_sample_noise_level'],
        dynamic_thresholding=config['dynamic_thresholding'],
        dynamic_thresholding_percentile=config['dynamic_thresholding_percentile'],
        device=device).eval()
    stated = getattr(torch, config['param_dtype'])
    if any(p.dtype != stated for p in imagen.parameters()):
        raise ValueError(f'the cascade does not hold its weights in {stated}')
    server = None
    if mix['entry'] == 'server':
        server = it.ImagenServer(imagen, batch_size=mix['prompts'],
                                 text_len=config['max_text_len'],
                                 cond_scale=config['cond_scale'], warmup=False)
    system = System(imagen, server,
                    [u for u in imagen.unets if not isinstance(u, it.NullUnet)], mix, config)
    record_steps(system)
    return system


def weights_of(seed, device):
    """The weights of stage `index` for its (name, shape) list, from `seed`."""
    return lambda index, specs: weights.make(specs, weights.derive(seed, 'weights', index),
                                             device)


def load_weights(system, seed, device):
    """The reference's parameters, by name, into the program's U-Nets: a name
    that one side has and the other lacks raises."""
    make = weights_of(seed, device)
    for index, unet in enumerate(system.imagen.unets):
        if unet in system.unets:
            unet.load_state_dict(make(index, specs(system.config, index)), strict=True)


def warm(system, request):
    """The program's own warm-up at the serving shape: `ImagenServer.warmup`
    for the server, one request of the mix's shape otherwise."""
    if system.server is not None:
        system.server.warmup()
    else:
        serve(system, request)


def warm_up(system, request_of):
    """`warm` on request -1, which the window never sends."""
    warm(system, request_of(-1))


def checked(seed, mix):
    """The requests whose answers are judged: `check_requests` of the first
    `check_from`, drawn from the seed."""
    import numpy as np
    rng = np.random.default_rng(weights.derive(seed, 'check'))
    return sorted(int(i) for i in rng.choice(mix['check_from'], mix['check_requests'],
                                             replace=False))


def settle(system, request_of, index):
    """Nothing to finish after the window; returns the next request's index."""
    return index


def findings(system, check, kept):
    """What the check needs once the program is freed: the checked requests
    and, for each that came, its images and states."""
    return check, kept


def serve(system, request, states=None):
    """One request through the mix's entry; the images (n, H, W, 3) in [0, 1]
    on the host. A list `states` receives the request's states (`record_steps`)."""
    system.states = states
    try:
        return _serve(system, request)
    finally:
        system.states = None


def _serve(system, request):
    device = request['text_embeds'].device
    gen = torch.Generator(device=device).manual_seed(request['noise_seed'])
    if system.server is not None:
        out = system.server.generate(text_embeds=request['text_embeds'],
                                     text_masks=request['text_masks'], generator=gen)
        return torch.from_numpy(out)
    out = system.imagen.sample(
        text_embeds=request['text_embeds'], text_masks=request['text_masks'],
        cond_scale=system.config['cond_scale'],
        start_at_unet_number=system.mix['start_at_unet_number'],
        start_image_or_video=request.get('start_image'), generator=gen, use_tqdm=False)
    return out.float().cpu()


def _sample_kwargs(config, mix, request):
    return dict(image_sizes=config['image_sizes'], steps=config['timesteps'],
                text_embeds=request['text_embeds'], text_masks=request['text_masks'],
                cond_scale=config['cond_scale'],
                start_at=mix['start_at_unet_number'], start_image=request.get('start_image'),
                lowres_noise_level=config['lowres_sample_noise_level'],
                percentile=config['dynamic_thresholding_percentile'])


def reference_unets(config, seed, device):
    numerics.no_tf32()
    return build_reference(config, weights_of(seed, device), device)


def judge(config, mix, seed, device, request_of, found):
    """The numbers of each checked request, the reference following its states."""
    check, kept = found
    unets = reference_unets(config, seed, device)
    readings = []
    for i in check:
        if i not in kept:
            readings.append(dict(correctness.FAILED))
            continue
        images, states = kept[i]
        readings.append(correctness.numbers(images, follow(unets, config, mix, request_of(i),
                                                           states)))
    return readings


def follow(unets, config, mix, request, states):
    """`ddpm.follow` of a request's recorded `states` in float32."""
    gen = torch.Generator(device=request['text_embeds'].device).manual_seed(
        request['noise_seed'])
    return ddpm.follow(unets, states, generator=gen, **_sample_kwargs(config, mix, request))


def control(unets, config, mix, request):
    """The control in the program's place: the reference's own sampler with
    every product in float8; returns (images on the host, its states on the host)."""
    gen = torch.Generator(device=request['text_embeds'].device).manual_seed(
        request['noise_seed'])
    states = []
    with numerics.precision('fp8'):
        out = ddpm.sample(unets, generator=gen, states=states,
                          **_sample_kwargs(config, mix, request))
    return out.cpu(), [[x.cpu() for x in trail] for trail in states]
