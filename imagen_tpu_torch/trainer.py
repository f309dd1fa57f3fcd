"""ImagenTrainer: one-unet-at-a-time training; counterpart of
`imagen_tpu/trainer.py` for one process on one device.

- Per unet, lazily: an optimiser (`optimizer='adam'`, or `'adafactor'`:
  `optim.Adafactor`, factored second moment and bf16 momentum), an EMA copy
  of the unet and a step count. The update is the optax chain of the JAX
  trainer (`_make_optimizer`) in its order: clip by global norm (optax's
  `g * min(1, max_norm / |g|)`, not `clip_grad_norm_`, which adds 1e-6 to
  the norm), weight decay added to the gradient before the moments (only
  tensors of ndim >= 2 in the JAX layout when `group_wd_params`: two
  parameter groups), then Adam or Adafactor at the warmup + cosine
  learning rate of the count of prior updates.
- Gradient accumulation: a batch larger than `max_batch_size` runs as
  chunks whose losses are weighted by their share of the batch, so the
  gradient is the full batch's; ragged batches end in a smaller chunk.
  Batches are images or, for a video cascade, clips with their prompt
  frames, split along the batch axis only.
- Every random draw (times, noise, crops, the text drop) comes from the
  trainer's `torch.Generator`, seeded by `seed`, on the imagen's device.
- Checkpoints are the JAX trainer's bundle (`model`, `version`, `steps`,
  `optim{i}`, `ema`) written by `torch.save`.

The imagen may be an `Imagen` or an `ElucidatedImagen`: the loss is what
`imagen(...)` returns.

Not ported yet (ROADMAP): dataloaders and `train_step` /
`valid_step`, checkpoint folders and their rotation, meshes and sharded
state, multi-process training.
"""
from __future__ import annotations

import copy
import math
import os
from contextlib import contextmanager

import numpy as np
import torch

from imagen_tpu_torch.ema import EMAConfig, ema_update
from imagen_tpu_torch.models.unet2d import NullUnet
from imagen_tpu_torch.optim import Adafactor
from imagen_tpu_torch.utils.helpers import cast_tuple, default, exists
from imagen_tpu_torch.utils.profiling import StepTimer
from imagen_tpu_torch.version import __version__


def groupby_prefix_and_trim(prefix, d):
    """Split kwargs by prefix, dropping the prefix."""
    with_prefix = {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}
    rest = {k: v for k, v in d.items() if not k.startswith(prefix)}
    return with_prefix, rest


def _decays(p):
    """The `group_wd_params` rule, ndim >= 2, read in the JAX package's layout:
    trailing singleton dims do not count, so a ChanRMSNorm gain (C, 1, 1) is
    a vector there and is not decayed, while a 1x1 conv (O, I, 1, 1) is a
    matrix and is."""
    shape = list(p.shape)
    while shape and shape[-1] == 1:
        shape.pop()
    return len(shape) >= 2


def _batch_size(batch):
    return next(v for v in batch.values() if isinstance(v, torch.Tensor)).shape[0]


def split_batch_for_accum(batch, max_batch_size):
    """(b, ...) -> (n_chunks, mb, ...) when max_batch_size divides b evenly
    and is smaller; else (batch, 1)."""
    b = _batch_size(batch)
    if not exists(max_batch_size) or b <= max_batch_size or b % max_batch_size != 0:
        return batch, 1
    n_chunks = b // max_batch_size
    return {k: v.reshape(n_chunks, max_batch_size, *v.shape[1:]) for k, v in batch.items()
            if exists(v)}, n_chunks


def split_batch_ragged(batch, max_batch_size):
    """Full chunks of max_batch_size plus one remainder chunk; returns
    (chunks, sizes)."""
    b = _batch_size(batch)
    q, r = divmod(b, max_batch_size)
    bounds = [(i * max_batch_size, (i + 1) * max_batch_size) for i in range(q)]
    if r:
        bounds.append((q * max_batch_size, b))
    chunks = [{k: v[lo:hi] for k, v in batch.items() if exists(v)} for lo, hi in bounds]
    return chunks, [hi - lo for lo, hi in bounds]


def _chunks(batch, max_batch_size):
    """[(chunk, weight)]: the batch's chunks of at most max_batch_size rows,
    each weighted by its share of the batch."""
    b = _batch_size(batch)
    if exists(max_batch_size) and b > max_batch_size and b % max_batch_size:
        chunks, sizes = split_batch_ragged(batch, max_batch_size)
        return [(c, n / b) for c, n in zip(chunks, sizes)]
    stacked, n = split_batch_for_accum(batch, max_batch_size)
    if n == 1:
        return [(batch, 1.)]
    return [({k: v[i] for k, v in stacked.items()}, 1. / n) for i in range(n)]


class ImagenTrainer:
    """Trains the unets of an `Imagen` one at a time, on the imagen's device."""

    def __init__(self, imagen, *, use_ema=True, lr=1e-4, eps=1e-8, beta1=0.9, beta2=0.99,
                 optimizer='adam', max_grad_norm=None, weight_decay=0.0,
                 group_wd_params=True, warmup_steps=None, cosine_decay_max_steps=None,
                 only_train_unet_number=None, fp16=False, precision=None, seed=0,
                 verbose=True, **kwargs):
        ema_kwargs, kwargs = groupby_prefix_and_trim('ema_', kwargs)
        if kwargs:
            raise TypeError(f'ImagenTrainer got unexpected keyword arguments: {sorted(kwargs)}')
        unknown = set(ema_kwargs) - set(EMAConfig.__dataclass_fields__)
        if unknown:
            raise TypeError(f'ImagenTrainer got unexpected ema_ arguments: {sorted(unknown)}')

        self.imagen = imagen
        self.num_unets = imagen.num_unets
        self.device = imagen.device
        self.verbose = verbose

        if fp16 and exists(precision):
            raise ValueError('pass fp16 or precision, not both')
        precision = default(precision, 'bf16' if fp16 else None)
        if precision not in (None, 'bf16', 'fp16'):
            raise ValueError(f'unknown precision {precision!r}')
        if exists(precision):
            # bf16 activations over fp32 parameters, as the JAX trainer runs
            # both 'bf16' and 'fp16'
            for unet in imagen.unets:
                if not isinstance(unet, NullUnet):
                    unet.set_compute_dtype(torch.bfloat16)
        self.precision = precision

        (self.lrs, self.optim_eps, self.warmup_steps, self.cosine_decay_max_steps,
         self.optimizer_kinds, self.weight_decays) = (
            cast_tuple(x, self.num_unets) for x in
            (lr, eps, warmup_steps, cosine_decay_max_steps, optimizer, weight_decay))
        for kind in self.optimizer_kinds:
            if kind not in ('adam', 'adafactor'):
                raise ValueError(f'unknown optimizer {kind!r}')
        self.beta1, self.beta2 = beta1, beta2
        self.max_grad_norm = max_grad_norm
        self.group_wd_params = group_wd_params

        self.use_ema = use_ema
        self.ema_config = EMAConfig(**ema_kwargs)
        self.only_train_unet_number = only_train_unet_number

        self.optimizers = [None] * self.num_unets
        self.ema_unets = [None] * self.num_unets
        self.steps = np.zeros(self.num_unets, dtype=np.int64)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.step_timer = StepTimer()
        self._pending = None       # (index, weight) of forward() calls not yet applied
        self._ema_swapped = False

    def print(self, msg):
        if self.verbose:
            print(msg)

    def timings(self):
        """Rolling step wall-time stats (mean, p50, p90, steps per second)."""
        return self.step_timer.summary()

    def validate_unet_number(self, unet_number=None):
        if self.num_unets == 1:
            unet_number = default(unet_number, 1)
        if not exists(unet_number) or not 0 < unet_number <= self.num_unets:
            raise ValueError(f'unet number should be in between 1 and {self.num_unets}')
        return unet_number

    def num_steps_taken(self, unet_number=None):
        return int(self.steps[self.validate_unet_number(unet_number) - 1])

    @property
    def unets(self):
        return self.imagen.unets

    # --- optimiser -----------------------------------------------------------------------

    def _lr(self, index, count):
        """The JAX trainer's `_lr_schedule` at `count` prior updates."""
        lr = self.lrs[index]
        cos_t, warmup = self.cosine_decay_max_steps[index], self.warmup_steps[index]
        if exists(cos_t):
            lr = lr * 0.5 * (1 + math.cos(math.pi * min(max(count / cos_t, 0.), 1.)))
        if exists(warmup):
            lr = lr * min((count + 1) / warmup, 1.)
        return lr

    def get_lr(self, unet_number):
        index = self.validate_unet_number(unet_number) - 1
        return self._lr(index, int(self.steps[index]))

    def _make_optimizer(self, index):
        params = self._params(index)
        wd = self.weight_decays[index]
        if self.group_wd_params:
            groups = [{'params': [p for p in params if _decays(p)], 'weight_decay': wd},
                      {'params': [p for p in params if not _decays(p)], 'weight_decay': 0.}]
        else:
            groups = [{'params': params, 'weight_decay': wd}]
        if self.optimizer_kinds[index] == 'adafactor':
            # the JAX trainer's optax.adafactor: beta2 is the exponent of the
            # second moment's decay schedule, beta1 the bf16 momentum; no eps
            return Adafactor(groups, lr=self.lrs[index], decay_rate=self.beta2,
                             momentum=self.beta1)
        return torch.optim.Adam(groups, lr=self.lrs[index], betas=(self.beta1, self.beta2),
                                eps=self.optim_eps[index],
                                fused=self.device.type == 'cuda')

    def _ensure_state(self, index):
        if exists(self.optimizers[index]):
            return
        self.optimizers[index] = self._make_optimizer(index)
        if self.use_ema:
            self.ema_unets[index] = copy.deepcopy(self.unets[index]).requires_grad_(False)

    def _params(self, index):
        return [p for p in self.unets[index].parameters() if p.requires_grad]

    @torch.no_grad()
    def _clip_grads(self, grads):
        """optax.clip_by_global_norm: g * min(1, max_norm / |g|), the norm over
        every gradient of the unet."""
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        factor = (self.max_grad_norm / norm).clamp(max=1.)
        torch._foreach_mul_(grads, factor)

    def _apply_update(self, index):
        """Clip, decay, Adam and EMA on the gradients in `.grad`."""
        if self._ema_swapped:
            raise RuntimeError('cannot take train steps inside use_ema_unets()')
        params = self._params(index)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if exists(self.max_grad_norm):
            self._clip_grads([p.grad for p in params])
        opt = self.optimizers[index]
        lr = self._lr(index, int(self.steps[index]))
        for group in opt.param_groups:
            group['lr'] = lr
        opt.step()
        opt.zero_grad(set_to_none=True)
        self.steps[index] += 1
        if self.use_ema:
            unet, ema = self.unets[index], self.ema_unets[index]
            ema_update(self.ema_config, ema.parameters(), unet.parameters(),
                       int(self.steps[index]))

    # --- training ------------------------------------------------------------------------

    def _check_trainable(self, unet_number):
        unet_number = self.validate_unet_number(unet_number)
        if exists(self.only_train_unet_number) and self.only_train_unet_number != unet_number:
            raise ValueError(f'you can only train unet #{self.only_train_unet_number}')
        return unet_number - 1

    def _backward(self, index, batch, max_batch_size, scale=1.):
        """Accumulate scale * d(loss)/d(params) into `.grad`; returns the loss.
        The batch's tensors are split along their first axis; its other
        entries (a flag such as `ignore_time`) go to every chunk."""
        self.unets[index].train()
        tensors = {k: v for k, v in batch.items() if isinstance(v, torch.Tensor)}
        options = {k: v for k, v in batch.items() if k not in tensors}
        loss = 0.
        for chunk, weight in _chunks(tensors, max_batch_size):
            chunk = dict(chunk)
            images = chunk.pop('images')
            chunk_loss = self.imagen(images, unet_number=index + 1, generator=self.generator,
                                     **chunk, **options)
            (chunk_loss * (weight * scale)).backward()
            loss = loss + chunk_loss.detach() * weight
        return loss

    def step_with_batch(self, batch, *, unet_number=None, max_batch_size=None, **extra):
        """One optimiser step of unet `unet_number` on `batch` (a dict with
        'images' (b, h, w, c), or clips (b, f, h, w, c) for a video cascade,
        and, for a text-conditioned imagen, 'text_embeds' and optionally
        'text_masks'; a video cascade also takes 'cond_video_frames',
        'post_cond_video_frames' and 'ignore_time'); returns the loss as a
        float."""
        if self._ema_swapped:
            raise RuntimeError('cannot take train steps inside use_ema_unets()')
        index = self._check_trainable(unet_number)
        if exists(self._pending):
            raise RuntimeError('forward() gradients are pending: call update() first')
        self._ensure_state(index)
        batch = {k: v for k, v in {**batch, **extra}.items() if exists(v)}
        self.step_timer.start()
        loss = self._backward(index, batch, max_batch_size)
        self._apply_update(index)
        loss = float(loss)
        self.step_timer.stop(self.device)
        return loss

    def forward(self, *, unet_number=None, max_batch_size=None, **batch):
        """Loss and gradient without the optimiser step (follow with `update`).
        Calls before an update accumulate, weighted by batch size, so
        N x forward + update averages over every sample they saw."""
        index = self._check_trainable(unet_number)
        if exists(self._pending) and self._pending[0] != index:
            raise RuntimeError('accumulated forward() calls must target the same unet')
        self._ensure_state(index)
        batch = {k: v for k, v in batch.items() if exists(v)}
        b = _batch_size(batch)
        loss = self._backward(index, batch, max_batch_size, scale=float(b))
        weight = (self._pending[1] if exists(self._pending) else 0) + b
        self._pending = (index, weight)
        return float(loss)

    def update(self, unet_number=None):
        """Apply the gradients of the forward() calls since the last update,
        as their mean over every sample seen."""
        index = self.validate_unet_number(unet_number) - 1
        if not exists(self._pending) or self._pending[0] != index:
            raise RuntimeError('call forward(...) before update()')
        weight = self._pending[1]
        self._pending = None
        grads = [p.grad for p in self._params(index) if p.grad is not None]
        torch._foreach_div_(grads, float(weight))
        self._apply_update(index)

    # --- sampling ------------------------------------------------------------------------

    @contextmanager
    def use_ema_unets(self):
        """Swap each unet's EMA copy into the imagen for the `with` block
        (a unet never trained gets one now, a copy of its weights); training
        inside the block raises."""
        if not self.use_ema:
            yield self.imagen.unets
            return
        for i in range(self.num_unets):
            self._ensure_state(i)
        originals = list(self.imagen.unets)
        for i, ema in enumerate(self.ema_unets):
            self.imagen.unets[i] = ema
        self._ema_swapped = True
        try:
            yield self.imagen.unets
        finally:
            for i, unet in enumerate(originals):
                self.imagen.unets[i] = unet
            self._ema_swapped = False

    def sample(self, *args, use_non_ema=False, **kwargs):
        """`Imagen.sample` through the EMA unets (the online ones with
        `use_non_ema`), drawing from the trainer's generator by default;
        `video_frames` and the prompt frames pass through."""
        kwargs.setdefault('generator', self.generator)
        if use_non_ema or not self.use_ema:
            return self.imagen.sample(*args, **kwargs)
        with self.use_ema_unets():
            return self.imagen.sample(*args, **kwargs)

    # --- checkpoints ---------------------------------------------------------------------

    def state_dict(self, without_optim_and_sched=False):
        """The JAX trainer's bundle: `model` (one state_dict per unet),
        `version`, `steps`, `optim{i}` and `ema`, every state made first."""
        for i in range(self.num_unets):
            self._ensure_state(i)
        bundle = dict(model=[u.state_dict() for u in self.unets], version=__version__,
                      steps=np.array(self.steps))
        if not without_optim_and_sched:
            for i, opt in enumerate(self.optimizers):
                bundle[f'optim{i}'] = opt.state_dict()
        if self.use_ema:
            bundle['ema'] = [e.state_dict() for e in self.ema_unets]
        return bundle

    def load_state_dict(self, bundle, only_model=False, strict=True):
        """Restore from a bundle of `state_dict`. `strict=False` loads the
        tensors whose names and shapes match and leaves the rest."""
        for i in range(self.num_unets):
            self._ensure_state(i)
            _load_module(self.unets[i], bundle['model'][i], strict)
        if bundle.get('version') != __version__:
            self.print(f'loading checkpoint from version {bundle.get("version")}, '
                       f'current package version is {__version__}')
        if only_model:
            return
        self.steps = np.array(bundle['steps'], dtype=np.int64)
        for i, opt in enumerate(self.optimizers):
            if f'optim{i}' in bundle:
                opt.load_state_dict(bundle[f'optim{i}'])
        if self.use_ema and 'ema' in bundle:
            for ema, sd in zip(self.ema_unets, bundle['ema']):
                _load_module(ema, sd, strict)

    def save(self, path, overwrite=True, without_optim_and_sched=False, **kwargs):
        """torch.save the bundle (plus any extra `kwargs` entries) to `path`."""
        path = str(path)
        if os.path.exists(path) and not overwrite:
            raise FileExistsError(f'{path} exists and overwrite is False')
        torch.save({**self.state_dict(without_optim_and_sched), **kwargs}, path)
        self.print(f'checkpoint saved to {path}')

    def load(self, path, only_model=False, strict=True, noop_if_not_exist=False):
        path = str(path)
        if not os.path.exists(path):
            if noop_if_not_exist:
                self.print(f'trainer checkpoint not found at {path}')
                return None
            raise FileNotFoundError(f'{path} does not exist')
        bundle = torch.load(path, map_location=self.device, weights_only=False)
        self.load_state_dict(bundle, only_model=only_model, strict=strict)
        self.print(f'checkpoint loaded from {path}')
        return bundle


def _load_module(module, state, strict):
    if strict:
        module.load_state_dict(state, strict=True)
        return
    own = module.state_dict()
    module.load_state_dict({k: v for k, v in state.items()
                            if k in own and own[k].shape == v.shape}, strict=False)
