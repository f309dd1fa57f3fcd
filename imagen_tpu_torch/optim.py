"""Adafactor with the semantics of the JAX trainer's optax chain.

`ImagenTrainer(optimizer='adafactor')` builds the chain the JAX trainer
builds (`imagen_tpu/trainer.py`, `_make_optimizer`): clip by global norm,
then weight decay added to the gradient, then `optax.adafactor` with
`decay_rate=beta2`, `momentum=beta1`, a bf16 momentum and
`min_dim_size_to_factor=128`. The trainer clips; this optimiser takes the
rest, per tensor, in optax's order (optax's other defaults kept):
- weight decay: g + wd * p (the group's `weight_decay`);
- the factored second moment (`optax.scale_by_factored_rms`): with
  decay_t = 1 - (count + 1) ** -decay_rate and g2 = g^2 + eps, a tensor
  whose two largest dims are both >= MIN_DIM_SIZE_TO_FACTOR keeps the
  row mean v_row (over the largest dim) and the column mean v_col (over the
  second largest) of g2, each an EMA at decay_t, and its update is
  g * (v_row / mean(v_row))^-1/2 * v_col^-1/2; every other tensor keeps the
  full EMA v and its update is g * v^-1/2;
- `clip_by_block_rms(1)`: u / max(1, rms(u));
- the learning rate, then `scale_by_param_block_rms`: u * max(rms(p), 1e-3);
- the momentum (`optax.ema(beta1, debias=False)`): m = (1 - beta1) * u +
  beta1' * m, kept in bf16, the update being the fp32 value; beta1' is beta1
  rounded to bf16, as optax's bf16 accumulator takes the decay;
- p - u.

The factored estimate is symmetric in its two axes (each factor's row or
column mean has the same total), so the port's parameter layout (the
weights bridge permutes axes: a Dense (I, O) is a Linear (O, I), HWIO is
OIHW) factors the same two sizes as the JAX layout and gives the same
update. The state per tensor is that of the optax bundle: the count, v_row
and v_col or v, and the bf16 momentum.

Under a mesh (`blocks`, a `parallel.layout.UnetLayout`) a tensor may be a
rank's block of a larger one (ZeRO-1, FSDP): its factoring follows the full
shape, and the means over a cut dim and the block RMS norms sum the ranks'
partial sums, as GSPMD's reductions over sharded axes do.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from imagen_tpu_torch.utils.helpers import exists


# optax.adafactor's defaults, which the JAX trainer keeps (it sets
# min_dim_size_to_factor to its default, 128, and dtype_momentum to bf16)
MIN_DIM_SIZE_TO_FACTOR = 128
EPS = 1e-30                  # added to g^2
CLIPPING_THRESHOLD = 1.      # clip_by_block_rms
MIN_PARAM_SCALE = 1e-3       # scale_by_param_block_rms


def factored_dims(shape):
    """(second largest dim, largest dim) of `shape` when both are at least
    MIN_DIM_SIZE_TO_FACTOR, else None (optax's `_factored_dims`)."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])
    d1, d0 = order[-2], order[-1]
    if shape[d1] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return d1, d0


class Adafactor(torch.optim.Optimizer):
    """`optax.adafactor` after `optax.add_decayed_weights` (see the module
    docstring). `decay_rate` is the exponent of the second moment's decay
    schedule; `momentum` None keeps no first moment. The momentum is kept
    in `momentum_dtype`."""

    momentum_dtype = torch.bfloat16

    def __init__(self, params, lr=1e-3, *, decay_rate=0.8, momentum=None, weight_decay=0.,
                 blocks=None):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))
        self.decay_rate = decay_rate
        self.momentum = momentum
        self.blocks = blocks

    def _full_shape(self, p):
        shape = self.blocks.full_shape(p) if exists(self.blocks) else None
        return tuple(p.shape) if shape is None else shape

    @staticmethod
    def reduced_dim(key, full_shape):
        """The dim of its parameter that state `key` is reduced over: the
        largest for v_row, the second largest for v_col, else None."""
        dims = factored_dims(full_shape)
        return {'v_row': dims[1], 'v_col': dims[0]}.get(key) if exists(dims) else None

    @property
    def decay_kept(self):
        """The decay that the momentum keeps: optax multiplies the accumulator
        by the decay in the accumulator's dtype, so beta1 rounded to it
        (0.8984375 for 0.9 in bf16); the product itself is not rounded."""
        return float(torch.tensor(self.momentum, dtype=self.momentum_dtype))

    def _init_state(self, p):
        state = self.state[p]
        state['step'] = 0
        dims = factored_dims(self._full_shape(p))
        if exists(dims):
            d1, d0 = dims
            state['v_row'] = p.new_zeros([n for i, n in enumerate(p.shape) if i != d0])
            state['v_col'] = p.new_zeros([n for i, n in enumerate(p.shape) if i != d1])
        else:
            state['v'] = torch.zeros_like(p)
        if exists(self.momentum):
            state['momentum'] = torch.zeros_like(p, dtype=self.momentum_dtype)
        return state

    def _scaled_by_rms(self, p, g, state):
        """The factored (or full) second-moment update of one tensor; the
        moments advance in `state`."""
        f32 = np.float32
        decay = f32(1.) - f32(state['step'] + 1) ** f32(-self.decay_rate)
        keep, take = float(decay), float(f32(1.) - decay)
        g2 = g * g + EPS
        full_shape = self._full_shape(p)
        dims = factored_dims(full_shape)
        if not exists(dims):
            v = state['v']
            v.mul_(keep).add_(g2, alpha=take)
            return g * v ** -0.5
        d1, d0 = dims
        if full_shape == tuple(p.shape):
            def mean(x, dim, of, keepdim=False):
                return x.mean(dim=dim, keepdim=keepdim)
        else:   # a block: the mean over dim `of` of p sums the ranks' parts
            def mean(x, dim, of, keepdim=False):
                return self.blocks.sum(x.sum(dim=dim, keepdim=keepdim), p, (of,)) / full_shape[of]
        v_row, v_col = state['v_row'], state['v_col']
        v_row.mul_(keep).add_(mean(g2, d0, d0), alpha=take)
        v_col.mul_(keep).add_(mean(g2, d1, d1), alpha=take)
        row_mean = mean(v_row, d1 - 1 if d1 > d0 else d1, d1, keepdim=True)
        row_factor = (v_row / row_mean) ** -0.5
        return g * row_factor.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            params = [p for p in group['params'] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            if group['weight_decay']:
                grads = torch._foreach_add(grads, params, alpha=group['weight_decay'])
            states = [self.state[p] or self._init_state(p) for p in params]
            updates = [self._scaled_by_rms(p, g, s) for p, g, s in zip(params, grads, states)]

            # block-RMS clip, learning rate and parameter scale: one factor per tensor
            sizes = torch.tensor([math.sqrt(math.prod(self._full_shape(p))) for p in params],
                                 device=params[0].device)
            norm_u = torch.stack(torch._foreach_norm(updates))
            norm_p = torch.stack(torch._foreach_norm(params))
            if exists(self.blocks):
                norm_u = self.blocks.global_norms(params, norm_u)
                norm_p = self.blocks.global_norms(params, norm_p)
            rms_u, rms_p = norm_u / sizes, norm_p / sizes
            factor = (group['lr'] * rms_p.clamp(min=MIN_PARAM_SCALE)
                      / (rms_u / CLIPPING_THRESHOLD).clamp(min=1.))
            torch._foreach_mul_(updates, list(factor.unbind()))

            if exists(self.momentum):
                moments = [s['momentum'] for s in states]
                torch._foreach_mul_(updates, 1. - self.momentum)
                torch._foreach_add_(updates, moments, alpha=self.decay_kept)
                torch._foreach_copy_(moments, updates)
            torch._foreach_sub_(params, updates)
            for s in states:
                s['step'] += 1

    def load_state_dict(self, state_dict):
        """`torch.optim.Optimizer.load_state_dict`, with the momentum kept in
        its own dtype (the base class casts every state tensor to its
        parameter's)."""
        super().load_state_dict(state_dict)
        for state in self.state.values():
            if 'momentum' in state:
                state['momentum'] = state['momentum'].to(self.momentum_dtype)
