"""Cascaded EDM (Karras et al. 2022) sampling: the `ElucidatedImagen` class.

Counterpart of `imagen_tpu/diffusion/elucidated.py`, for text-conditioned
image cascades. The stochastic churn + second-order Heun sampler is a plain
Python loop over the steps of each stage: the sigma schedule and the churn
factors are float32 numpy on the host, so whether a step takes the Heun
correction (sigma_next != 0) is a Python `if` with no device sync. Every
denoiser call is the EDM-preconditioned U-Net, with classifier-free
guidance as one doubled-batch forward and the clamp or dynamic threshold.

The class is an `Imagen` whose sampler is EDM's: it shares the cascade's
plumbing (the unets' conditioning configs, the device, resizing, dynamic
thresholding, the low-res noise augmentation and the stage loop of
`sample`), as the JAX class borrows `Imagen`'s methods. `sample` runs the
EDM sampler; the DDPM training loss is not EDM's, and `forward` raises.

Not ported yet (they raise NotImplementedError): EDM training, inpainting
and RePaint, `init_images` and `skip_steps`, `cond_images`, video, `texts=`
(T5), `return_pil_images`.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from imagen_tpu_torch.diffusion.imagen import Imagen, unet_forward_with_cond_scale
from imagen_tpu_torch.ops import edm_math
from imagen_tpu_torch.ops.edm_math import Hparams
from imagen_tpu_torch.ops.tensor_utils import right_pad_dims_to
from imagen_tpu_torch.utils.helpers import cast_tuple, default, exists

_OVERRIDE_KEYS = ('init', 'eps', 'lowres')


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
        if resize_mode != 'nearest':
            raise NotImplementedError(f'resize_mode {resize_mode!r}: only nearest is ported')
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
            temporal_downsample_factor=temporal_downsample_factor, device=device)
        if self.is_video:   # and with it `resize_cond_video_frames`, which only video reads
            raise NotImplementedError('video EDM sampling is not ported yet')
        num_unets = self.num_unets
        lowres = tuple(u.lowres_cond for u in self.unets)
        if lowres != (False, *((True,) * (num_unets - 1))):
            raise ValueError(f'only the unets after the first take low-res conditioning, '
                             f'got {lowres}')
        hparams = [num_sample_steps, sigma_min, sigma_max, sigma_data, rho, P_mean, P_std,
                   S_churn, S_tmin, S_tmax, S_noise]
        self.hparams = [Hparams(*hp) for hp in
                        zip(*(cast_tuple(h, num_unets) for h in hparams))]

    def forward(self, *args, **kwargs):
        raise NotImplementedError('EDM training is not ported yet')

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

    def _sample_stage(self, index, *, batch_size, frames, cond_scale, unet_kwargs, init_noise,
                      step_noises, generator, sigma_min, sigma_max):
        """The churn + Heun sampler of one stage; `step_noises` are the churn
        draws, (num_sample_steps, 1, b, s, s, c) as the JAX override."""
        unet = self.unets[index]
        hp = self.hparams[index]
        size = self.image_sizes[index]
        shape = (batch_size, size, size, self.channels)
        device = self.device
        steps = hp.num_sample_steps
        if exists(init_noise) and tuple(init_noise.shape) != shape:
            raise ValueError(f'init noise of stage {index + 1} is {tuple(init_noise.shape)}, '
                             f'expected {shape}')
        if exists(step_noises) and tuple(step_noises.shape) != (steps, 1, *shape):
            raise ValueError(f'churn noise of stage {index + 1} is {tuple(step_noises.shape)}, '
                             f'expected {(steps, 1, *shape)}')

        def randn():
            return torch.randn(shape, generator=generator, device=device)

        sigmas = edm_math.sample_schedule(steps, hp.rho, default(sigma_min[index], hp.sigma_min),
                                          default(sigma_max[index], hp.sigma_max))
        gammas = edm_math.gammas_for_schedule(sigmas, steps, hp.S_churn, hp.S_tmin, hp.S_tmax)
        kwargs = dict(sigma_data=hp.sigma_data, clamp=True, cond_scale=cond_scale,
                      dynamic_threshold=self.dynamic_thresholding[index], **unet_kwargs)
        f = sigmas.dtype.type
        s_noise = f(hp.S_noise)

        images = float(sigmas[0]) * (init_noise.to(device) if exists(init_noise) else randn())
        for i in range(steps):
            sigma, sigma_next = sigmas[i], sigmas[i + 1]
            sigma_hat = sigma + gammas[i] * sigma
            churn = np.sqrt(np.maximum(sigma_hat ** 2 - sigma ** 2, f(0.)))
            images_hat = images
            if churn > 0:   # the stochastic churn: sigma_hat > sigma only where gamma > 0
                eps = step_noises[i, 0].to(device) if exists(step_noises) else randn()
                images_hat = images + float(churn) * (float(s_noise) * eps)

            model_output = self.preconditioned_network_forward(
                unet, images_hat, sigma_hat, **kwargs)
            denoised_over_sigma = (images_hat - model_output) / float(sigma_hat)
            images_next = images_hat + float(sigma_next - sigma_hat) * denoised_over_sigma

            if sigma_next != 0:   # the Heun correction
                model_output_next = self.preconditioned_network_forward(
                    unet, images_next, sigma_next, **kwargs)
                denoised_prime = (images_next - model_output_next) / float(sigma_next)
                images = images_hat + float(f(0.5) * (sigma_next - sigma_hat)) * (
                    denoised_over_sigma + denoised_prime)
            else:
                images = images_next
        return self.unnormalize_img(images.clamp(-1., 1.))

    # --- public sampling API -------------------------------------------------------------

    @staticmethod
    def _override_triple(entry):
        """A stage's `noise_override` entry as (init, eps, lowres)."""
        if entry is None:
            return None
        if isinstance(entry, torch.Tensor):
            return entry, None, None
        if not isinstance(entry, dict):
            raise ValueError(f'a noise_override entry is None, a tensor or a dict, '
                             f'got {type(entry).__name__}')
        if 'repaint' in entry:
            raise NotImplementedError('RePaint is not ported to the EDM sampler yet')
        unknown = set(entry) - set(_OVERRIDE_KEYS)
        if unknown:
            raise ValueError(f'unknown noise_override keys {sorted(unknown)}; '
                             f'expected {_OVERRIDE_KEYS}')
        return tuple(entry.get(k) for k in _OVERRIDE_KEYS)

    @torch.no_grad()
    def sample(self, *, texts=None, text_masks=None, text_embeds=None, cond_images=None,
               cond_video_frames=None, post_cond_video_frames=None, inpaint_videos=None,
               inpaint_images=None, inpaint_masks=None, init_images=None, skip_steps=None,
               sigma_min=None, sigma_max=None,
               video_frames=None, batch_size=1, cond_scale=1., lowres_sample_noise_level=None,
               start_at_unet_number=1, start_image_or_video=None, stop_at_unet_number=None,
               return_all_unet_outputs=False, return_pil_images=False,
               noise_override: Optional[Sequence] = None, offload_inactive_unets=False,
               generator: Optional[torch.Generator] = None):
        """Run the cascade with EDM; returns the last stage's NHWC images in
        [0, 1] (every stage's with `return_all_unet_outputs`).

        `sigma_min` / `sigma_max` override each stage's schedule ends (one
        value or one per unet). `noise_override`: per-stage list (entries may
        be None) of draws used instead of `generator`'s. An entry is the init
        noise (b, s, s, c), or a dict with the JAX keys 'init' (b, s, s, c),
        'eps' (num_sample_steps, 1, b, s, s, c), the churn draws before
        S_noise, and 'lowres' (b, s, s, c), the low-res noise augmentation's
        draw for stages after the first. `offload_inactive_unets` as in
        `Imagen.sample`.
        """
        unported = dict(texts=texts, cond_images=cond_images, video_frames=video_frames,
                        cond_video_frames=cond_video_frames,
                        post_cond_video_frames=post_cond_video_frames,
                        inpaint_videos=inpaint_videos, inpaint_images=inpaint_images,
                        inpaint_masks=inpaint_masks, init_images=init_images,
                        skip_steps=skip_steps)
        named = [k for k, v in unported.items() if exists(v)]
        if return_pil_images:
            named.append('return_pil_images')
        if named:
            raise NotImplementedError(f'not ported to the EDM sampler yet: {", ".join(named)}')
        num_unets = self.num_unets
        noise_override = default(noise_override, (None,) * num_unets)
        if len(noise_override) != num_unets:
            raise ValueError('noise_override must be a per-stage list (entries may be None)')
        return self._sample_cascade(
            text_embeds=text_embeds, text_masks=text_masks, batch_size=batch_size, frames=None,
            cond_video_frames=None, post_cond_video_frames=None, cond_scale=cond_scale,
            start_at_unet_number=start_at_unet_number,
            start_image_or_video=start_image_or_video, stop_at_unet_number=stop_at_unet_number,
            noise_override=[self._override_triple(e) for e in noise_override],
            lowres_sample_noise_level=default(lowres_sample_noise_level,
                                              self.lowres_sample_noise_level),
            generator=generator, return_all_unet_outputs=return_all_unet_outputs,
            offload_inactive_unets=offload_inactive_unets,
            sigma_min=cast_tuple(sigma_min, num_unets), sigma_max=cast_tuple(sigma_max, num_unets))
