"""Cascaded EDM (Karras et al. 2022): the `ElucidatedImagen` class.

Counterpart of `imagen_tpu/diffusion/elucidated.py`, for text-conditioned
image and video cascades. The stochastic churn + second-order Heun sampler is a plain
Python loop over the steps of each stage: the sigma schedule and the churn
factors are float32 numpy on the host, so whether a step takes the Heun
correction (sigma_next != 0) is a Python `if` with no device sync. Every
denoiser call is the EDM-preconditioned U-Net, with classifier-free
guidance as one doubled-batch forward and the clamp or dynamic threshold.

The class is an `Imagen` whose sampler and loss are EDM's: it shares the cascade's
plumbing (the unets' conditioning configs, the device, resizing, dynamic
thresholding, the low-res noise augmentation, the stage loop of
`sample` and the input handling of `forward`), as the JAX class borrows `Imagen`'s methods. `sample` runs the
EDM sampler, with the DDPM sampler's surface: inpainting with RePaint
resampling, `init_images` and `skip_steps`, `cond_images`, self-conditioned
unets, a per-call low-res noise level, every stage's output and PIL images;
a cascade of `Unet3D`s samples NFHWC video. `forward` is the EDM training
loss: log-normal sigmas, the preconditioned denoiser (the unet in train
mode) and the lambda(sigma) weight. `resize_mode` and
`resize_cond_video_frames` are `Imagen`'s.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from imagen_tpu_torch.diffusion.imagen import (
    Imagen,
    _per_sample_random_crop,
    check_draw_shapes,
    override_draws,
    unet_forward_with_cond_scale,
    unet_mode,
)
from imagen_tpu_torch.ops import edm_math
from imagen_tpu_torch.ops.edm_math import Hparams
from imagen_tpu_torch.ops.tensor_utils import right_pad_dims_to
from imagen_tpu_torch.parallel.rows import rows_of
from imagen_tpu_torch.utils.helpers import cast_tuple, default, exists
from imagen_tpu_torch.utils.profiling import span

_OVERRIDE_KEYS = ('init', 'eps', 'repaint', 'lowres')


class ElucidatedImagen(Imagen):
    """Cascade of unets sampled with EDM. Keyword names mirror the JAX
    `ElucidatedImagen` fields; each EDM hyperparameter takes one value or
    one per unet (`self.hparams[i]` is stage i's `Hparams`)."""

    def __init__(self, unets, *, image_sizes, text_encoder_name='google/t5-v1_1-base',
                 text_embed_dim=None, channels=3, cond_drop_prob=0.1, random_crop_sizes=None,
                 resize_mode='nearest', temporal_downsample_factor=1,
                 resize_cond_video_frames=True, lowres_sample_noise_level=0.2,
                 per_sample_random_aug_noise_level=False, condition_on_text=True,
                 auto_normalize_img=True, dynamic_thresholding=True,
                 dynamic_thresholding_percentile=0.95, only_train_unet_number=None,
                 lowres_noise_schedule='linear', num_sample_steps=32, sigma_min=0.002,
                 sigma_max=80, sigma_data=0.5, rho=7, P_mean=-1.2, P_std=1.2, S_churn=80,
                 S_tmin=0.05, S_tmax=50, S_noise=1.003, device=None):
        super().__init__(
            unets, image_sizes=image_sizes, text_encoder_name=text_encoder_name,
            text_embed_dim=text_embed_dim, channels=channels, cond_drop_prob=cond_drop_prob,
            random_crop_sizes=random_crop_sizes, lowres_noise_schedule=lowres_noise_schedule,
            lowres_sample_noise_level=lowres_sample_noise_level,
            per_sample_random_aug_noise_level=per_sample_random_aug_noise_level,
            condition_on_text=condition_on_text, auto_normalize_img=auto_normalize_img,
            dynamic_thresholding=dynamic_thresholding,
            dynamic_thresholding_percentile=dynamic_thresholding_percentile,
            only_train_unet_number=only_train_unet_number,
            temporal_downsample_factor=temporal_downsample_factor, resize_mode=resize_mode,
            resize_cond_video_frames=resize_cond_video_frames, device=device)
        num_unets = self.num_unets
        lowres = tuple(u.lowres_cond for u in self.unets)
        if lowres != (False, *((True,) * (num_unets - 1))):
            raise ValueError(f'only the unets after the first take low-res conditioning, '
                             f'got {lowres}')
        hparams = [num_sample_steps, sigma_min, sigma_max, sigma_data, rho, P_mean, P_std,
                   S_churn, S_tmin, S_tmax, S_noise]
        self.hparams = [Hparams(*hp) for hp in
                        zip(*(cast_tuple(h, num_unets) for h in hparams))]

    # --- training loss ---------------------------------------------------------------------

    def forward(self, images, *, unet_number=None, texts=None, text_embeds=None,
                text_masks=None, cond_images=None, cond_video_frames=None,
                post_cond_video_frames=None, ignore_time=False, sigmas=None, noise=None,
                lowres_aug_times=None, lowres_aug_noise=None, self_cond_flip=None,
                generator=None):
        """EDM training loss of unet `unet_number` on a batch of NHWC images, or
        NFHWC clips for a video cascade, in [0, 1] (or uint8); the inputs as
        `Imagen.forward` takes them (still images train a video cascade as
        one-frame clips with `ignore_time`).

        In the JAX loss's order: the low-res augmentation times, the paired
        random crop of the images and the low-res condition, the condition's
        augmentation noise, the log-normal sigmas and the unit noise, each
        drawn from `generator` unless given (`sigmas` (b,), `noise` at the
        cropped images' shape, `lowres_aug_times`, `lowres_aug_noise`). Then
        `images + sigma * noise` through the preconditioned denoiser, with,
        for a unet with `self_cond`, half of the time (a fair coin from
        `generator`, or `self_cond_flip`) the denoised images of a first pass
        without gradient as `self_cond`, else zeros. The loss is the per-sample
        mean of (denoised - images)^2 in fp32 times lambda(sigma), averaged
        over the batch."""
        batch = self._training_batch(
            images, unet_number=unet_number, texts=texts, text_embeds=text_embeds,
            text_masks=text_masks, cond_images=cond_images, cond_video_frames=cond_video_frames,
            post_cond_video_frames=post_cond_video_frames, ignore_time=ignore_time)
        unet, hp = self.unets[batch.index], self.hparams[batch.index]
        images, lowres_cond_img = batch.images, batch.lowres_cond_img
        b, device = images.shape[0], images.device

        def randn(shape, dtype):
            return rows_of(lambda n: torch.randn((n, *shape[1:]), generator=generator,
                                                 device=device, dtype=dtype), shape[0])

        if exists(lowres_cond_img):
            lowres_aug_times = default(lowres_aug_times,
                                       lambda: self._lowres_aug_times(b, generator))
            lowres_cond_img = self.normalize_img(lowres_cond_img)
        images = self.normalize_img(images)
        crop = self.random_crop_sizes[batch.index]
        if exists(crop):
            images, *rest = _per_sample_random_crop(
                (images, *((lowres_cond_img,) if exists(lowres_cond_img) else ())), crop,
                generator)
            lowres_cond_img = rest[0] if rest else None

        kwargs = dict(batch.cond, sigma_data=hp.sigma_data, cond_drop_prob=self.cond_drop_prob,
                      generator=generator)
        if exists(lowres_cond_img):
            lowres_aug_noise = default(
                lowres_aug_noise, lambda: randn(lowres_cond_img.shape, lowres_cond_img.dtype))
            kwargs['lowres_cond_img'], *_ = self.lowres_noise_schedule.q_sample(
                lowres_cond_img, lowres_aug_times, lowres_aug_noise)
            kwargs['lowres_noise_times'] = self.lowres_noise_schedule.get_condition(
                lowres_aug_times)

        sigmas = default(sigmas, lambda: rows_of(lambda n: self.noise_distribution(
            hp.P_mean, hp.P_std, n, generator=generator), b))
        noise = default(noise, lambda: randn(images.shape, images.dtype))
        noised_images = images + right_pad_dims_to(images, sigmas) * noise

        if unet.self_cond:
            if self_cond_flip is None:
                self_cond_flip = bool(torch.rand((), generator=generator, device=device) < 0.5)
            self_cond = torch.zeros_like(noised_images)
            if self_cond_flip:
                with torch.no_grad(), unet_mode(unet, True):
                    self_cond = self.preconditioned_network_forward(
                        unet, noised_images, sigmas, **kwargs).detach()
            kwargs['self_cond'] = self_cond

        with unet_mode(unet, True):
            denoised = self.preconditioned_network_forward(unet, noised_images, sigmas,
                                                           **kwargs)
        losses = (denoised.float() - images.float()) ** 2
        losses = losses.reshape(b, -1).mean(dim=-1)
        return (losses * self.loss_weight(hp.sigma_data, sigmas.float())).mean()

    def sample_schedule(self, num_sample_steps, rho, sigma_min, sigma_max):
        return edm_math.sample_schedule(num_sample_steps, rho, sigma_min, sigma_max)

    def loss_weight(self, sigma_data, sigma):
        return edm_math.loss_weight(sigma_data, sigma)

    def noise_distribution(self, P_mean, P_std, batch_size, generator=None):
        """(batch_size,) log-normal training sigmas on the cascade's device,
        drawn from `generator` (where the JAX method takes a key)."""
        return edm_math.noise_distribution(P_mean, P_std, batch_size, generator=generator,
                                           device=self.device)

    # --- preconditioning -----------------------------------------------------------------

    def preconditioned_network_forward(self, unet, noised_images, sigma, *, sigma_data,
                                       clamp=False, dynamic_threshold=True, cond_scale=1.,
                                       **kwargs):
        """EDM eq. (7): c_skip * x + c_out * F(c_in * x, c_noise(sigma)), then
        the clamp or the dynamic threshold when `clamp`. `sigma` is one number
        for the whole batch (the coefficients are then host floats) or a (b,)
        tensor."""
        batch = noised_images.shape[0]
        device = noised_images.device
        if isinstance(sigma, torch.Tensor):
            padded = right_pad_dims_to(noised_images, sigma.to(device))
            time = edm_math.c_noise(sigma.to(device))
            sigma_data = float(sigma_data)
        else:
            # float32 on the host, as the JAX package's float32 sigma (float64
            # for a float64 one)
            f = edm_math.host_float(sigma)
            padded, sigma_data = f(sigma), f(sigma_data)
            time = torch.full((batch,), float(edm_math.c_noise(padded)), device=device,
                              dtype=torch.float64 if f is np.float64 else torch.float32)

        def coef(c):
            return c if isinstance(c, torch.Tensor) else float(c)

        net_out = unet_forward_with_cond_scale(
            unet, coef(edm_math.c_in(sigma_data, padded)) * noised_images, time,
            cond_scale=cond_scale, **kwargs)
        out = (coef(edm_math.c_skip(sigma_data, padded)) * noised_images
               + coef(edm_math.c_out(sigma_data, padded)) * net_out)
        if not clamp:
            return out
        return self.threshold_x_start(out, dynamic_threshold)

    # --- one cascade stage ---------------------------------------------------------------

    def _sample_stage(self, index, *, batch_size, frames, cond_scale, unet_kwargs, noise,
                      generator, sigma_min, sigma_max, inpaint_images=None, inpaint_masks=None,
                      resample_times=1, init_images=None, skip_steps=0):
        """The churn + Heun sampler of one stage. The images start at
        sigmas[0] times the noise, plus `init_images`, whatever `skip_steps`
        drops of the schedule. Each (step, r) adds the churn; inpainting pastes
        the known region plus the same churn noise (even when the churn is
        0) before the denoiser and, unless r or the step is the last, RePaint
        renoises by (sigma - sigma_next) times a draw; the known pixels are
        pasted exactly at the end. A unet with `self_cond` sees the previous
        denoised output, the Heun call the Euler step's. `noise` may hold the
        JAX draws 'init' (b, s, s, c), 'eps' (the churn draws before S_noise)
        and 'repaint', each (steps - skip_steps, R, b, s, s, c); a video
        stage's draws have a frame axis after the batch, (b, f, s, s, c)."""
        unet = self.unets[index]
        hp = self.hparams[index]
        size = self.image_sizes[index]
        shape = (batch_size, *((frames,) if exists(frames) else ()), size, size, self.channels)
        device = self.device
        steps = hp.num_sample_steps
        inpainting = exists(inpaint_images)
        per_step = (steps - skip_steps, resample_times, *shape)
        check_draw_shapes(noise, index, init=shape, eps=per_step, repaint=per_step)

        def draw(name, *at):
            if name in noise:
                return noise[name][at].to(device)
            return torch.randn(shape, generator=generator, device=device)

        sigmas = self.sample_schedule(steps, hp.rho, default(sigma_min[index], hp.sigma_min),
                                      default(sigma_max[index], hp.sigma_max))
        gammas = edm_math.gammas_for_schedule(sigmas, steps, hp.S_churn, hp.S_tmin, hp.S_tmax)
        kwargs = dict(sigma_data=hp.sigma_data, clamp=True, cond_scale=cond_scale,
                      dynamic_threshold=self.dynamic_thresholding[index], **unet_kwargs)
        f = sigmas.dtype.type
        s_noise = f(hp.S_noise)

        images = float(sigmas[0]) * draw('init')
        if exists(init_images):
            images = images + init_images
        x_start = torch.zeros_like(images)
        for i in range(skip_steps, steps):
            with span('sample.step'):
                sigma, sigma_next = sigmas[i], sigmas[i + 1]
                sigma_hat = sigma + gammas[i] * sigma
                churn = np.sqrt(np.maximum(sigma_hat ** 2 - sigma ** 2, f(0.)))
                for r in range(resample_times):
                    images_hat, known = images, inpaint_images
                    if churn > 0:   # the stochastic churn: sigma_hat > sigma only where gamma > 0
                        added = float(churn) * (float(s_noise) * draw('eps', i - skip_steps, r))
                        images_hat = images + added
                        known = inpaint_images + added if inpainting else None
                    if inpainting:
                        images_hat = torch.where(inpaint_masks, known, images_hat)

                    self_cond = dict(self_cond=x_start) if unet.self_cond else {}
                    model_output = self.preconditioned_network_forward(
                        unet, images_hat, sigma_hat, **self_cond, **kwargs)
                    denoised_over_sigma = (images_hat - model_output) / float(sigma_hat)
                    images_next = images_hat + float(sigma_next - sigma_hat) * denoised_over_sigma

                    if sigma_next != 0:   # the Heun correction
                        self_cond = dict(self_cond=model_output) if unet.self_cond else {}
                        x_start = self.preconditioned_network_forward(
                            unet, images_next, sigma_next, **self_cond, **kwargs)
                        denoised_prime = (images_next - x_start) / float(sigma_next)
                        images = images_hat + float(f(0.5) * (sigma_next - sigma_hat)) * (
                            denoised_over_sigma + denoised_prime)
                    else:
                        images, x_start = images_next, model_output

                    if inpainting and r < resample_times - 1 and i < steps - 1:
                        images = images + float(sigma - sigma_next) * draw('repaint',
                                                                           i - skip_steps, r)
        images = images.clamp(-1., 1.)
        if inpainting:
            images = torch.where(inpaint_masks, inpaint_images, images)
        return self.unnormalize_img(images)

    # --- public sampling API -------------------------------------------------------------

    @staticmethod
    def _override_dict(entry):
        """A stage's `noise_override` entry as a dict of `_OVERRIDE_KEYS`."""
        if entry is None:
            return {}
        if isinstance(entry, torch.Tensor):
            return {'init': entry}
        if not isinstance(entry, dict):
            raise ValueError(f'a noise_override entry is None, a tensor or a dict, '
                             f'got {type(entry).__name__}')
        return override_draws(entry, _OVERRIDE_KEYS)

    @torch.no_grad()
    def sample(self, *, texts=None, text_masks=None, text_embeds=None, cond_images=None,
               cond_video_frames=None, post_cond_video_frames=None, inpaint_videos=None,
               inpaint_images=None, inpaint_masks=None, inpaint_resample_times=5,
               init_images=None, skip_steps=None, sigma_min=None, sigma_max=None,
               video_frames=None, batch_size=1, cond_scale=1., lowres_sample_noise_level=None,
               start_at_unet_number=1, start_image_or_video=None, stop_at_unet_number=None,
               return_all_unet_outputs=False, return_pil_images=False,
               noise_override: Optional[Sequence] = None, offload_inactive_unets=False,
               use_tqdm=True, generator: Optional[torch.Generator] = None):
        """Run the cascade with EDM; returns the last stage's NHWC images, or
        NFHWC video of a video cascade, in [0, 1] (every stage's with
        `return_all_unet_outputs`, PIL images with `return_pil_images`). The
        keywords are `Imagen.sample`'s (`video_frames`, prompt frames and
        `inpaint_videos` with a (b, h, w) or (b, f, h, w) mask for video).

        `sigma_min` / `sigma_max` override each stage's schedule ends (one
        value or one per unet). `noise_override`: per-stage list (entries may
        be None) of draws used instead of `generator`'s. An entry is the init
        noise (b, s, s, c), or a dict with the JAX keys 'init' (b, s, s, c),
        'eps' (num_sample_steps - skip_steps, R, b, s, s, c), the churn draws
        before S_noise per (step, r), 'repaint' (the same shape), RePaint's
        renoise draws (the last r's and the last step's unused), and 'lowres'
        (b, s, s, c), the low-res noise augmentation's draw for stages after
        the first; R is `inpaint_resample_times` when inpainting, else 1. A
        video stage's draws have a frame axis after the batch.
        `offload_inactive_unets` and `use_tqdm` as in `Imagen.sample`.
        """
        num_unets = self.num_unets
        return self._sample_cascade(
            texts=texts, text_embeds=text_embeds, text_masks=text_masks, batch_size=batch_size,
            video_frames=video_frames, cond_images=cond_images,
            cond_video_frames=cond_video_frames, post_cond_video_frames=post_cond_video_frames,
            inpaint_images=default(inpaint_videos, inpaint_images), inpaint_masks=inpaint_masks,
            inpaint_resample_times=inpaint_resample_times, init_images=init_images,
            skip_steps=skip_steps, cond_scale=cond_scale,
            lowres_sample_noise_level=lowres_sample_noise_level,
            start_at_unet_number=start_at_unet_number,
            start_image_or_video=start_image_or_video, stop_at_unet_number=stop_at_unet_number,
            noise_override=noise_override, generator=generator,
            return_all_unet_outputs=return_all_unet_outputs,
            return_pil_images=return_pil_images, offload_inactive_unets=offload_inactive_unets,
            use_tqdm=use_tqdm, sigma_min=cast_tuple(sigma_min, num_unets),
            sigma_max=cast_tuple(sigma_max, num_unets))
