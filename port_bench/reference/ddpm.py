"""A plain float32 cascaded DDPM sampler, the reference for the served images.

Continuous-time DDPM in the log-SNR form of the Imagen paper as lucidrains'
imagen-pytorch v2.0.0 samples it: the cosine schedule for every stage, T
ancestral steps on linspace(1, 0, T + 1), classifier-free guidance as one
forward of the conditional and the null rows, dynamic thresholding at the
95th percentile of |x0| per image, and for a super-resolution stage the
low-res image resized by nearest neighbour and noised to level 0.2 under
the linear schedule. Images are NHWC in [0, 1]; a stage's state is NHWC in
[-1, 1] after its last step's clamp.

The noise comes from a `torch.Generator`, drawn in the sampler's documented
order: per stage, the low-res augmentation noise (a stage that has one),
then the initial image, then one draw per step (the last one multiplied by
zero). Every draw is (b, s, s, 3) float32 on the generator's device.

`sample` runs the cascade on its own states. `follow` takes a sampler's
states (its initial image and each step's output, for every stage) and
computes each step again from the state before it, so that an error in one
step is measured alone: with random weights a trajectory is chaotic, and a
difference of one rounding grows step by step.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def log_snr(t, schedule):
    t = t.float()
    if schedule == 'cosine':
        inner = torch.cos((t + 0.008) / 1.008 * math.pi * 0.5) ** -2 - 1
        return -torch.log(inner.clamp(min=1e-5))
    if schedule == 'linear':
        return -torch.log(torch.expm1(1e-4 + 10 * t ** 2).clamp(min=1e-12))
    raise ValueError(f'unknown schedule {schedule}')


def alpha_sigma(ls):
    return torch.sqrt(torch.sigmoid(ls)), torch.sqrt(torch.sigmoid(-ls))


def col(t):
    return t[:, None, None, None]


def threshold(x0, percentile):
    """Dynamic thresholding: clamp to +-s and divide by s, s the percentile of
    |x0| per image, at least 1."""
    s = torch.quantile(x0.reshape(x0.shape[0], -1).abs(), percentile, dim=-1).clamp(min=1.)
    s = col(s)
    return x0.clamp(-s, s) / s


def nearest_resize(img, size):
    """NHWC nearest-neighbour resize sampling at pixel centres."""
    out = F.interpolate(img.permute(0, 3, 1, 2), size=size, mode='nearest-exact')
    return out.permute(0, 2, 3, 1)


def guided(unet, x, log_snr_t, cond_scale, unet_kwargs):
    """Classifier-free guidance: the conditional and null rows in one forward."""
    b = x.shape[0]

    def two(t):
        return torch.cat((t, t)) if t is not None else None

    drop = torch.cat((torch.zeros(b, dtype=torch.bool, device=x.device),
                      torch.ones(b, dtype=torch.bool, device=x.device)))
    out = unet(two(x), two(log_snr_t), drop_text=drop,
               **{k: two(v) for k, v in unet_kwargs.items()})
    cond, null = out[:b], out[b:]
    return null + (cond - null) * cond_scale


def step(unet, img, t, t_next, noise, *, cond_scale, unet_kwargs, percentile,
         schedule='cosine'):
    """One ancestral step from time t to t_next (each (b,))."""
    ls, ls_next = log_snr(t, schedule), log_snr(t_next, schedule)
    alpha, sigma = alpha_sigma(col(ls))
    eps = guided(unet, img, ls, cond_scale, unet_kwargs)
    x0 = threshold((img - sigma * eps) / alpha.clamp(min=1e-8), percentile)
    alpha_next, sigma_next = alpha_sigma(col(ls_next))
    c = -torch.expm1(col(ls) - col(ls_next))
    mean = alpha_next * (img * (1 - c) / alpha + c * x0)
    log_var = torch.log((sigma_next ** 2 * c).clamp(min=1e-20))
    last = (t_next == 0).float()
    return mean + col(1. - last) * torch.exp(0.5 * log_var) * noise


def times(steps, batch, device):
    """(t, t_next) of each step, each (b,)."""
    grid = torch.linspace(1., 0., steps + 1, device=device)
    return [(grid[i].expand(batch), grid[i + 1].expand(batch)) for i in range(steps)]


def stage_kwargs(unet, img, size, text_embeds, text_masks, generator, lowres_noise_level):
    """The U-Net's conditioning at a stage; draws the low-res noise of a
    super-resolution stage from `generator`. `img` is the stage before's
    output in [0, 1]."""
    kwargs = dict(text_embeds=text_embeds, text_mask=text_masks)
    if unet.lowres_cond:
        batch, device = text_embeds.shape[0], text_embeds.device
        lowres = nearest_resize(img.float(), size) * 2 - 1
        noise = torch.randn(lowres.shape, generator=generator, device=device)
        ls = log_snr(torch.full((batch,), lowres_noise_level, device=device), 'linear')
        alpha, sigma = alpha_sigma(col(ls))
        kwargs.update(lowres_cond_img=alpha * lowres + sigma * noise, lowres_noise_times=ls)
    return kwargs


@torch.no_grad()
def sample(unets, *, image_sizes, steps, text_embeds, text_masks, cond_scale, generator,
           start_at=1, start_image=None, lowres_noise_level=0.2, percentile=0.95,
           states=None):
    """Sample the cascade from stage `start_at` (counted from 1; a later start
    takes `start_image` in [0, 1]); returns the last stage's images, NHWC in
    [0, 1]. `unets[i]` is stage i's U-Net (None for a stage not run). With a
    list `states`, each stage appends [initial image, each step's output]."""
    device, batch = text_embeds.device, text_embeds.shape[0]
    img = None if start_at == 1 else nearest_resize(start_image.float(),
                                                    image_sizes[start_at - 2])
    for index in range(start_at - 1, len(unets)):
        size = image_sizes[index]
        kwargs = stage_kwargs(unets[index], img, size, text_embeds, text_masks, generator,
                              lowres_noise_level)
        x = torch.randn((batch, size, size, 3), generator=generator, device=device)
        trail = [x]
        for t, t_next in times(steps[index], batch, device):
            noise = torch.randn(x.shape, generator=generator, device=device)
            x = step(unets[index], x, t, t_next, noise, cond_scale=cond_scale,
                     unet_kwargs=kwargs, percentile=percentile)
            trail.append(x)
        if states is not None:
            states.append(trail)
        img = (x.clamp(-1., 1.) + 1) * 0.5
    return img


@torch.no_grad()
def follow(unets, states, *, image_sizes, steps, text_embeds, text_masks, cond_scale,
           generator, start_at=1, start_image=None, lowres_noise_level=0.2,
           percentile=0.95):
    """Each step of a sampler's `states` (as `sample` records them) computed
    again from the state before it, with the same draws from `generator`.

    Returns (start, [(stage, step, error)], answer): `start` is the largest
    difference of an initial image from this side's draw; each error is the
    step's output less this side's step from the same input (on `states`'
    device); `answer` is the images in [0, 1] that the last state gives."""
    device, batch = text_embeds.device, text_embeds.shape[0]
    img = None if start_at == 1 else nearest_resize(start_image.float(),
                                                    image_sizes[start_at - 2])
    start, errors = 0., []
    for stage, index in enumerate(range(start_at - 1, len(unets))):
        trail = states[stage]
        size = image_sizes[index]
        kwargs = stage_kwargs(unets[index], img, size, text_embeds, text_masks, generator,
                              lowres_noise_level)
        init = torch.randn((batch, size, size, 3), generator=generator, device=device)
        start = max(start, (trail[0].to(device) - init).abs().max().item())
        for i, (t, t_next) in enumerate(times(steps[index], batch, device)):
            noise = torch.randn(init.shape, generator=generator, device=device)
            ours = step(unets[index], trail[i].to(device).float(), t, t_next, noise,
                        cond_scale=cond_scale, unet_kwargs=kwargs, percentile=percentile)
            errors.append((index, i, trail[i + 1].float() - ours.to(trail[i + 1].device)))
        img = (trail[-1].to(device).float().clamp(-1., 1.) + 1) * 0.5
    return start, errors, img
