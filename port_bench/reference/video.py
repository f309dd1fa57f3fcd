"""A plain float32 DDPM sampler of clips, the reference for the served frames.

`reference.ddpm`'s sampler (its log-SNR schedule, steps, guidance) over
clips (b, f, s, s, 3) of one video stage, as the port's cascade samples a
`Unet3D` stage: T ancestral steps on linspace(1, 0, T + 1), classifier-free
guidance as one forward of the conditional and the null rows, and dynamic
thresholding at the percentile of |x0| over each whole clip. The noise
comes from a `torch.Generator`, drawn in the sampler's order: the initial
clip, then one draw per step (the last one multiplied by zero), each
(b, f, s, s, 3) float32 on the generator's device.

`sample` runs the stage on its own states; `follow` takes a sampler's
states (its initial clip and each step's output) and computes each step
again from the state before it, as `ddpm.follow` does for images. Its
errors and answer come back frame by frame, (b f, s, s, 3), so a frame
counts as an image in the compared numbers.
"""
from __future__ import annotations

import torch

from port_bench.reference.ddpm import alpha_sigma, guided, log_snr, times


def col(t):
    return t.reshape(-1, 1, 1, 1, 1)


def threshold(x0, percentile):
    """Clamp to +-s and divide by s, s the percentile of |x0| per clip, at least 1."""
    s = torch.quantile(x0.reshape(x0.shape[0], -1).abs(), percentile, dim=-1).clamp(min=1.)
    s = col(s)
    return x0.clamp(-s, s) / s


def step(unet, img, t, t_next, noise, *, cond_scale, unet_kwargs, percentile):
    """One ancestral step of clips from time t to t_next (each (b,))."""
    ls, ls_next = log_snr(t, 'cosine'), log_snr(t_next, 'cosine')
    alpha, sigma = alpha_sigma(col(ls))
    eps = guided(unet, img, ls, cond_scale, unet_kwargs)
    x0 = threshold((img - sigma * eps) / alpha.clamp(min=1e-8), percentile)
    alpha_next, sigma_next = alpha_sigma(col(ls_next))
    c = -torch.expm1(col(ls) - col(ls_next))
    mean = alpha_next * (img * (1 - c) / alpha + c * x0)
    log_var = torch.log((sigma_next ** 2 * c).clamp(min=1e-20))
    last = (t_next == 0).float()
    return mean + col(1. - last) * torch.exp(0.5 * log_var) * noise


def frames(x):
    """(b, f, s, s, 3) -> (b f, s, s, 3)."""
    return x.reshape(-1, *x.shape[2:])


@torch.no_grad()
def sample(unet, *, frames_per_clip, image_size, steps, text_embeds, text_masks, cond_scale,
           generator, percentile=0.95, states=None):
    """Sample clips; returns their frames (b f, s, s, 3) in [0, 1]. With a
    list `states`, appends [initial clip, each step's output]."""
    device, batch = text_embeds.device, text_embeds.shape[0]
    kwargs = dict(text_embeds=text_embeds, text_mask=text_masks)
    x = torch.randn((batch, frames_per_clip, image_size, image_size, 3), generator=generator,
                    device=device)
    trail = [x]
    for t, t_next in times(steps, batch, device):
        noise = torch.randn(x.shape, generator=generator, device=device)
        x = step(unet, x, t, t_next, noise, cond_scale=cond_scale, unet_kwargs=kwargs,
                 percentile=percentile)
        trail.append(x)
    if states is not None:
        states.append(trail)
    return frames((x.clamp(-1., 1.) + 1) * 0.5)


@torch.no_grad()
def follow(unet, states, *, frames_per_clip, image_size, steps, text_embeds, text_masks,
           cond_scale, generator, percentile=0.95):
    """Each step of a sampler's `states` ([[initial clip, each step's
    output]], as `sample` records them) computed again from the state before
    it, with the same draws from `generator`.

    Returns (start, [(0, step, error)], answer): `start` is the largest
    difference of the initial clip from this side's draw; each error is the
    step's output less this side's step from the same input, frame by frame
    (on `states`' device); `answer` is the frames in [0, 1] that the last
    state gives."""
    device, batch = text_embeds.device, text_embeds.shape[0]
    (trail,) = states
    kwargs = dict(text_embeds=text_embeds, text_mask=text_masks)
    init = torch.randn((batch, frames_per_clip, image_size, image_size, 3), generator=generator,
                       device=device)
    start = (trail[0].to(device) - init).abs().max().item()
    errors = []
    for i, (t, t_next) in enumerate(times(steps, batch, device)):
        noise = torch.randn(init.shape, generator=generator, device=device)
        ours = step(unet, trail[i].to(device).float(), t, t_next, noise, cond_scale=cond_scale,
                    unet_kwargs=kwargs, percentile=percentile)
        errors.append((0, i, frames(trail[i + 1].float() - ours.to(trail[i + 1].device))))
    answer = frames((trail[-1].to(device).float().clamp(-1., 1.) + 1) * 0.5)
    return start, errors, answer
