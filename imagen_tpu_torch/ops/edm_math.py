"""Karras-style EDM (Elucidated Diffusion Model) math; counterpart of
`imagen_tpu/ops/edm_math.py`.

The preconditioning coefficients take numbers or tensors. The sigma
schedule and the churn factors are float32 numpy arrays on the host, so the
sampler's per-step choices (Heun or Euler) are Python `if`s on host floats
and cost no device sync.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from imagen_tpu_torch.ops.tensor_utils import log


class Hparams(NamedTuple):
    """Per-unet EDM hyperparameters."""
    num_sample_steps: int = 32
    sigma_min: float = 0.002
    sigma_max: float = 80.0
    sigma_data: float = 0.5
    rho: float = 7.0
    P_mean: float = -1.2
    P_std: float = 1.2
    S_churn: float = 80.0
    S_tmin: float = 0.05
    S_tmax: float = 50.0
    S_noise: float = 1.003


# derived preconditioning parameters, Table 1 of Karras et al. 2022

def c_skip(sigma_data, sigma):
    return (sigma_data ** 2) / (sigma ** 2 + sigma_data ** 2)


def c_out(sigma_data, sigma):
    return sigma * sigma_data * (sigma_data ** 2 + sigma ** 2) ** -0.5


def c_in(sigma_data, sigma):
    return 1 * (sigma ** 2 + sigma_data ** 2) ** -0.5


def host_float(x):
    """The numpy type of host-side sigma arithmetic: float64 for a float64
    sigma or schedule, else float32, as the JAX package's float32 sigmas."""
    return np.float64 if getattr(x, 'dtype', None) == np.float64 else np.float32


def c_noise(sigma):
    """log(sigma) / 4, the log clamped at 1e-12 as the JAX package's."""
    if isinstance(sigma, torch.Tensor):
        return log(sigma) * 0.25
    f = host_float(sigma)
    return np.log(np.maximum(f(sigma), f(1e-12))) * f(0.25)


def sample_schedule(num_sample_steps, rho, sigma_min, sigma_max):
    """rho-spaced sigma schedule, eq. (5): (num_sample_steps + 1,) float32
    with a trailing 0."""
    n = num_sample_steps
    inv_rho = 1 / rho
    steps = np.arange(n, dtype=np.float32)
    sigmas = (sigma_max ** inv_rho
              + steps / (n - 1) * (sigma_min ** inv_rho - sigma_max ** inv_rho)) ** rho
    return np.pad(sigmas.astype(np.float32), (0, 1))


def gammas_for_schedule(sigmas, num_sample_steps, S_churn, S_tmin, S_tmax):
    """Per-step churn factor: min(S_churn / N, sqrt(2) - 1) where S_tmin <=
    sigma <= S_tmax, else 0, in the schedule's dtype."""
    gamma = min(S_churn / num_sample_steps, 2 ** 0.5 - 1)
    in_range = (sigmas >= S_tmin) & (sigmas <= S_tmax)
    return np.where(in_range, gamma, 0.).astype(sigmas.dtype)


def loss_weight(sigma_data, sigma):
    """lambda(sigma) of the training loss."""
    return (sigma ** 2 + sigma_data ** 2) * (sigma * sigma_data) ** -2


def noise_distribution(P_mean, P_std, batch_size, generator=None, device=None):
    """Log-normal training sigmas, drawn from `generator`."""
    return torch.exp(P_mean + P_std * torch.randn((batch_size,), generator=generator,
                                                  device=device))
