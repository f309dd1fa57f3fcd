"""Continuous-time Gaussian diffusion math (log-SNR formulation), in fp32.

Counterpart of `imagen_tpu/ops/diffusion_math.py`
(`GaussianDiffusionContinuousTimes`). Noise is always passed in; random
times are drawn from an explicit `torch.Generator`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from imagen_tpu_torch.ops.tensor_utils import log, right_pad_dims_to
from imagen_tpu_torch.utils.helpers import default, exists


def beta_linear_log_snr(t):
    t = t.float()
    return -torch.log(torch.expm1(1e-4 + 10 * (t ** 2)))


def alpha_cosine_log_snr(t, s: float = 0.008):
    t = t.float()
    return -log((torch.cos((t + s) / (1 + s) * math.pi * 0.5) ** -2) - 1, eps=1e-5)


def log_snr_to_alpha_sigma(log_snr):
    return torch.sqrt(torch.sigmoid(log_snr)), torch.sqrt(torch.sigmoid(-log_snr))


NOISE_SCHEDULES = {
    'linear': beta_linear_log_snr,
    'cosine': alpha_cosine_log_snr,
}


@dataclass(frozen=True)
class GaussianDiffusionContinuousTimes:
    noise_schedule: str = 'cosine'
    timesteps: int = 1000

    def __post_init__(self):
        if self.noise_schedule not in NOISE_SCHEDULES:
            raise ValueError(f'invalid noise schedule {self.noise_schedule}')

    @property
    def num_timesteps(self):
        return self.timesteps

    def log_snr(self, t):
        return NOISE_SCHEDULES[self.noise_schedule](t)

    def get_times(self, batch_size, noise_level, device=None):
        return torch.full((batch_size,), noise_level, dtype=torch.float32,
                          device=device)

    def sample_random_times(self, batch_size, generator=None, device=None):
        """t ~ U(0, 1) per sample, drawn from `generator`."""
        return torch.rand((batch_size,), generator=generator, device=device,
                          dtype=torch.float32)

    def get_condition(self, times):
        return self.log_snr(times) if exists(times) else None

    def get_sampling_timesteps(self, batch, device=None):
        """(t, t_next), each (T, b), from linspace(1, 0, T + 1)."""
        times = torch.linspace(1., 0., self.num_timesteps + 1,
                               dtype=torch.float32, device=device)
        times = times[None].expand(batch, -1)
        return times[:, :-1].T, times[:, 1:].T

    def q_posterior(self, x_start, x_t, t, *, t_next=None):
        """Posterior q(x_{t_next} | x_t, x_start), eq. 33 of the VDM supplement."""
        t_next = default(t_next, lambda: (t - 1. / self.num_timesteps).clamp(min=0.))

        log_snr = right_pad_dims_to(x_t, self.log_snr(t))
        log_snr_next = right_pad_dims_to(x_t, self.log_snr(t_next))

        alpha, _ = log_snr_to_alpha_sigma(log_snr)
        alpha_next, sigma_next = log_snr_to_alpha_sigma(log_snr_next)

        c = -torch.expm1(log_snr - log_snr_next)
        posterior_mean = alpha_next * (x_t * (1 - c) / alpha + c * x_start)
        posterior_variance = (sigma_next ** 2) * c
        posterior_log_variance_clipped = log(posterior_variance, eps=1e-20)
        return posterior_mean, posterior_variance, posterior_log_variance_clipped

    def q_sample(self, x_start, t, noise):
        """alpha * x + sigma * noise; returns (x_noisy, log_snr, alpha, sigma)."""
        dtype = x_start.dtype
        if isinstance(t, float):
            t = torch.full((x_start.shape[0],), t, dtype=dtype, device=x_start.device)
        log_snr = self.log_snr(t).to(dtype)
        alpha, sigma = log_snr_to_alpha_sigma(right_pad_dims_to(x_start, log_snr))
        return alpha * x_start + sigma * noise, log_snr, alpha, sigma

    def q_sample_from_to(self, x_from, from_t, to_t, noise):
        """Renoise x from time `from_t` back to the earlier (noisier) `to_t`:
        RePaint's resampling step."""
        alpha, sigma = log_snr_to_alpha_sigma(right_pad_dims_to(x_from, self.log_snr(from_t)))
        alpha_to, sigma_to = log_snr_to_alpha_sigma(right_pad_dims_to(x_from, self.log_snr(to_t)))
        return x_from * (alpha_to / alpha) + noise * (sigma_to * alpha - sigma * alpha_to) / alpha

    def predict_start_from_v(self, x_t, t, v):
        alpha, sigma = log_snr_to_alpha_sigma(right_pad_dims_to(x_t, self.log_snr(t)))
        return alpha * x_t - sigma * v

    def predict_v_from_start_and_noise(self, x_start, t, noise):
        """v = alpha * noise - sigma * x_start, the v objective's target."""
        alpha, sigma = log_snr_to_alpha_sigma(right_pad_dims_to(x_start, self.log_snr(t)))
        return alpha * noise - sigma * x_start

    def predict_start_from_noise(self, x_t, t, noise):
        alpha, sigma = log_snr_to_alpha_sigma(right_pad_dims_to(x_t, self.log_snr(t)))
        return (x_t - sigma * noise) / alpha.clamp(min=1e-8)
