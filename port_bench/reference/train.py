"""A plain float32 training step of one U-Net: the loss, its gradients,
Adafactor and the EMA, the reference for the training cells.

The loss is `Imagen.forward`'s for a stage without a low-res condition, as
lucidrains' imagen-pytorch v2.0.0 defines it (`p_losses`): per row a time
t ~ U(0, 1), the cosine schedule's log-SNR at t, x_t = alpha x0 + sigma eps
with x0 the images moved to [-1, 1], classifier-free guidance's text drop
(a row keeps its text when its draw u ~ U(0, 1) is below 1 - cond_drop_prob),
the noise objective with the squared error averaged over a row's pixels,
and min-SNR weighting (arXiv 2303.09556): w = min(snr, gamma) / snr. The
batch's loss is the mean over rows of w times the row's error. The draws come
from one `torch.Generator` in `Imagen.forward`'s order, each float32 on the
generator's device: t (b,), eps (b, H, W, 3), then the keep draw (b,).

The gradients are autograd's, computed in blocks of rows, each block's loss
weighted by its share of the batch, so that a step at a large batch fits.

Adafactor (Shazeer & Stern 2018, arXiv:1804.04235) as optax composes it,
per tensor, with the step count t starting at 1:
- g2 = g^2 + 1e-30; the second moment decays at beta2_t = 1 - t^-c;
- a tensor whose two largest dims (d1 the second, d0 the largest) are both at
  least 128 keeps the row mean r (g2 averaged over d0) and the column mean
  c (over d1), each an average at beta2_t, and its step is
  g (r / mean_d1(r))^-1/2 c^-1/2; any other tensor keeps the whole average
  v and steps g v^-1/2;
- the step is clipped to a block RMS of at most 1, then scaled by the
  learning rate times max(RMS(p), 1e-3);
- momentum: m = (1 - beta1) u + beta1' m, held in bfloat16, beta1' being
  beta1 rounded to bfloat16; the parameter moves by -m, the float32 value.

The EMA, on the optimiser steps that `update_every` divides: e = d e +
(1 - d) p, with d = 1 - (1 + k / inv_gamma)^-power clamped to [min_value,
beta] for k = step - update_after_step - 1 > 0, and d = 0 (a copy) else.

Every product goes through `numerics`, so the control computes the same
step with its operands in float8.
"""
from __future__ import annotations

import torch

from port_bench.reference import ddpm

MIN_DIM_SIZE_TO_FACTOR = 128
EPS = 1e-30
CLIP = 1.
MIN_PARAM_SCALE = 1e-3


def draws(images, generator, cond_drop_prob):
    """The step's draws in `Imagen.forward`'s order: [t, eps, u] and the
    rows whose text is dropped."""
    b, device = images.shape[0], images.device
    t = torch.rand((b,), generator=generator, device=device, dtype=torch.float32)
    eps = torch.randn(images.shape, generator=generator, device=device, dtype=torch.float32)
    u = torch.rand((b,), generator=generator, device=device, dtype=torch.float32)
    return [t, eps, u], ~(u < 1 - cond_drop_prob)


def row_losses(unet, images, text_embeds, text_masks, t, eps, drop, min_snr_gamma):
    """Each row's weighted error (b,), from the noise objective."""
    ls = ddpm.log_snr(t, 'cosine')
    alpha, sigma = ddpm.alpha_sigma(ddpm.col(ls))
    x_t = alpha * (images.float() * 2 - 1) + sigma * eps
    pred = unet(x_t, ls, text_embeds=text_embeds, text_mask=text_masks, drop_text=drop)
    err = (pred.float() - eps).pow(2).flatten(1).mean(dim=1)
    snr = torch.exp(ls)
    return err * snr.clamp(max=min_snr_gamma) / snr


def loss_and_grads(unet, inputs, rows, min_snr_gamma):
    """The mean weighted loss over the rows of `inputs` (images, text_embeds,
    text_masks, t, eps, drop) and its gradients in each parameter's `.grad`,
    computed in blocks of `rows` rows."""
    n = inputs['images'].shape[0]
    for p in unet.parameters():
        p.grad = None
    total = 0.
    for lo in range(0, n, rows):
        block = {k: v[lo:lo + rows] for k, v in inputs.items()}
        loss = row_losses(unet, **block, min_snr_gamma=min_snr_gamma).sum() / n
        loss.backward()
        total += loss.item()
    return total


def factored_dims(shape):
    """(d1, d0): the second largest and the largest dim, both at least
    MIN_DIM_SIZE_TO_FACTOR; else None."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])
    d1, d0 = order[-2], order[-1]
    return (d1, d0) if shape[d1] >= MIN_DIM_SIZE_TO_FACTOR else None


class Adafactor:
    """Adafactor over named float32 tensors, state kept by name."""

    def __init__(self, lr, decay_rate, momentum):
        self.lr, self.decay_rate, self.momentum = lr, decay_rate, momentum
        self.momentum_kept = float(torch.tensor(momentum, dtype=torch.bfloat16))
        self.state = {}

    def scaled(self, name, g):
        """g over the root of its second moment, which advances."""
        s = self.state.setdefault(name, dict(step=0))
        t = s['step'] + 1
        beta2 = 1. - t ** -self.decay_rate
        g2 = g * g + EPS
        dims = factored_dims(g.shape)
        if dims is None:
            s['v'] = beta2 * s.get('v', torch.zeros_like(g)) + (1 - beta2) * g2
            return g * s['v'] ** -0.5
        d1, d0 = dims
        r = g2.mean(dim=d0)
        c = g2.mean(dim=d1)
        s['r'] = beta2 * s.get('r', torch.zeros_like(r)) + (1 - beta2) * r
        s['c'] = beta2 * s.get('c', torch.zeros_like(c)) + (1 - beta2) * c
        r_dim = d1 - 1 if d1 > d0 else d1   # d1's place once d0 is gone
        row = (s['r'] / s['r'].mean(dim=r_dim, keepdim=True)) ** -0.5
        return g * row.unsqueeze(d0) * (s['c'] ** -0.5).unsqueeze(d1)

    @torch.no_grad()
    def step(self, params):
        """One step of every tensor of {name: parameter} that has a gradient."""
        for name, p in params.items():
            u = self.scaled(name, p.grad.float())
            rms_u = u.pow(2).mean().sqrt()
            rms_p = p.pow(2).mean().sqrt()
            u = u / (rms_u / CLIP).clamp(min=1.) * self.lr * rms_p.clamp(min=MIN_PARAM_SCALE)
            s = self.state[name]
            m = (1. - self.momentum) * u + self.momentum_kept * s.get(
                'm', torch.zeros_like(u, dtype=torch.bfloat16)).float()
            s['m'] = m.to(torch.bfloat16)
            s['step'] += 1
            p.sub_(m)


def ema_decay(step, beta=0.9999, update_after_step=100, update_every=10, inv_gamma=1.,
              power=2 / 3, min_value=0.):
    """The EMA's decay at optimiser step `step`, None where it does not update."""
    if step % update_every:
        return None
    k = step - update_after_step - 1
    if k <= 0:
        return 0.
    return min(max(1. - (1. + k / inv_gamma) ** -power, min_value), beta)


def ema_update(ema, new, decay):
    """The EMA tensor after an update at `decay` toward `new`, in float32."""
    return ema.float() * decay + new.float() * (1. - decay)


def norms(tensors):
    """{name: float64 norm}."""
    return {k: v.double().norm().item() for k, v in tensors.items()}


def train(unet, batches, generator, *, lr, decay_rate, momentum, cond_drop_prob,
          min_snr_gamma, rows, state=None, used=None):
    """Optimiser steps of `unet` (its parameters move) on `batches`, each a
    dict of images (b, H, W, 3) in [0, 1], text_embeds and text_masks,
    drawing from `generator`, Adafactor starting from `state` (by name, as
    `Adafactor.state` keeps it; fresh by default). Returns each step's loss
    and draws, the norm of each parameter's first gradient and of its change
    over all the steps. `used` rows of each batch (all by default) enter the
    loss, whose mean is over them: the fault that leaves part of the batch out."""
    params = dict(unet.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    opt = Adafactor(lr, decay_rate, momentum)
    opt.state = state if state is not None else {}
    losses, taken, grads = [], [], None
    for batch in batches:
        drawn, drop = draws(batch['images'], generator, cond_drop_prob)
        inputs = dict(batch, t=drawn[0], eps=drawn[1], drop=drop)
        if used is not None:
            inputs = {k: v[:used] for k, v in inputs.items()}
        losses.append(loss_and_grads(unet, inputs, rows, min_snr_gamma))
        taken.append(drawn)
        if grads is None:
            grads = norms({k: p.grad for k, p in params.items()})
        opt.step(params)
    change = norms({k: p.detach() - start[k] for k, p in params.items()})
    return dict(losses=losses, draws=taken, grads=grads, change=change)
