"""Exponential moving average of parameters; counterpart of `imagen_tpu/ema.py`.

The same decay schedule `1 - (1 + epoch / inv_gamma) ** -power`, clamped to
[min_value, beta], the `update_after_step` warm start (decay 0: a copy of the
online weights) and the `update_every` thinning. `step` counts calls, one per
optimiser step, starting at 1. The EMA tensors are updated in place.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class EMAConfig:
    beta: float = 0.9999
    update_after_step: int = 100
    update_every: int = 10
    inv_gamma: float = 1.0
    power: float = 2 / 3
    min_value: float = 0.0


def ema_decay(config: EMAConfig, step: int) -> float:
    """The decay at call `step`, in fp32 as the JAX package computes it."""
    f32 = np.float32
    epoch = max(f32(step - config.update_after_step - 1), f32(0.))
    value = f32(1) - (f32(1) + epoch / f32(config.inv_gamma)) ** f32(-config.power)
    if epoch <= 0:
        value = f32(0.)
    return float(np.clip(value, f32(config.min_value), f32(config.beta)))


@torch.no_grad()
def ema_update(config: EMAConfig, ema_params, new_params, step: int):
    """ema <- ema * decay + new * (1 - decay) on the calls `update_every`
    divides; `ema_params` and `new_params` are matching iterables of tensors."""
    if step % config.update_every != 0:
        return
    decay = ema_decay(config, step)
    for e, p in zip(ema_params, new_params):
        e.mul_(decay).add_(p.to(e.dtype), alpha=1. - decay)
