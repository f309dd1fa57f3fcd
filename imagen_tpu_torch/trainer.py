"""ImagenTrainer: one-unet-at-a-time training; counterpart of
`imagen_tpu/trainer.py`, on one device or, with `mesh`, one process per GPU.

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
- Data: `add_train_dataset` / `add_valid_dataset` (the train set split
  with `split_valid_from_train`, the JAX rows; under a mesh each rank reads
  its rows, `_rank_rows`) or dataloaders of one's own;
  `train_step`, `valid_step` (no gradient, eval mode, the EMA unet with
  `use_ema_unets=True`) and `step_with_dl_iter` take the next batch, a dict
  or a tuple named by `dl_tuple_output_keywords_names`.
- Every random draw (times, noise, crops, the text drop) comes from the
  trainer's `torch.Generator`, seeded by `seed`, on the imagen's device.
- Checkpoints are the JAX trainer's bundle (`model`, `version`, `steps`,
  `optim{i}`, `ema`, and `imagen_type` / `imagen_params` for an imagen
  built from a config) written by `torch.save`, on a thread with
  `async_save`. With `checkpoint_path` and `checkpoint_every`, the trainer
  resumes from the newest `checkpoint.{total_steps}.ckpt` of that folder at
  construction, writes one every `checkpoint_every` optimiser steps and
  keeps the newest `max_checkpoints_keep`. `load(only_model=True)` also
  takes a bundle the JAX trainer wrote (its unet and EMA weights); its
  optax optimiser state does not carry across, so a full load of one raises.

The imagen may be an `Imagen` or an `ElucidatedImagen`: the loss is what
`imagen(...)` returns.

Several GPUs (`mesh`, a `parallel.mesh.create_mesh()` ('data', 'model')
`DeviceMesh`; one trainer a process, every rank calling every method):
- Each rank's steps take its own rows of the global batch (`data` x the
  local rows; the ranks of one 'model' group pass the same rows; ranks whose
  row counts differ raise). `max_batch_size` is per rank: accumulation chunk
  i is every rank's chunk i. Every draw is made over the global batch from
  the generator every rank holds alike, each rank keeping its rows
  (`parallel/rows.py`), so a step on the mesh equals a one-process step on
  the ranks' rows concatenated in rank order. The loss returned is the
  global mean.
- Placement (`_placement_splits`, the counterpart of the JAX trainer's
  `_placement_specs`): `fsdp` (True, or the least leaf size that shards)
  cuts the parameters, their moments and the EMA over 'data'
  (`fsdp_sharding_rules`); a 'model' axis cuts the large weights' output
  features over 'model' (`param_sharding_rules`), gathered before use, so
  every rank computes on whole weights; `shard_optimizer_states` (ZeRO-1)
  cuts only the optimiser state over 'data' (`zero_sharding_rules`). With
  none, or with data 1, the state is replicated and the gradients averaged
  (data parallelism). `parallel/layout.py` holds the mechanics; the global
  gradient norm sums the ranks' blocks.
- Rank 0 prints and writes. A save is collective: every rank enters the
  gather and rank 0 writes the same bundle, keys and layout as a
  one-process trainer's, whatever the mesh, so it loads into any layout. A
  load is symmetric: every rank reads. `checkpoint_backend='orbax'` writes
  each rank's blocks with `torch.distributed.checkpoint` (no gather) into a
  directory (`utils/sharded_ckpt.py`) and reads them back where the live
  trainer holds them. It keeps the bundle's `overwrite=False` contract
  (where the JAX orbax branch overwrites) and refuses a `checkpoint_fs`
  other than the local filesystem, which it cannot write through.

`split_batches` is accepted and read nowhere, as in the JAX trainer (an
Accelerate option in lucidrains').
"""
from __future__ import annotations

import copy
import math
import os
from contextlib import contextmanager, nullcontext

import numpy as np
import torch
import torch.distributed as dist

from imagen_tpu_torch.data import DataLoader, cycle, split_dataset
from imagen_tpu_torch.ema import EMAConfig, ema_update
from imagen_tpu_torch.models.unet2d import NullUnet
from imagen_tpu_torch.optim import Adafactor
from imagen_tpu_torch.parallel import mesh as mesh_lib
from imagen_tpu_torch.parallel.layout import MeshComm, UnetLayout, splits_of
from imagen_tpu_torch.parallel.rows import global_rows
from imagen_tpu_torch.utils.checkpoint_io import (
    as_list,
    get_fs,
    is_local_fs,
    load_obj,
    save_obj,
    to_cpu,
)
from imagen_tpu_torch.utils.helpers import cast_tuple, default, exists
from imagen_tpu_torch.utils.load import (
    is_flax_state, load_imagen_from_checkpoint, load_unet_state)
from imagen_tpu_torch.utils.profiling import StepTimer
from imagen_tpu_torch.version import __version__

CHECKPOINT_BACKENDS = (None, 'msgpack', 'orbax')

# keyword arguments of `sample` that carry one entry per sample, split by `max_batch_size`
_BATCHED = ('text_embeds', 'text_masks', 'cond_images', 'inpaint_images', 'inpaint_videos',
            'inpaint_masks', 'init_images', 'start_image_or_video', 'cond_video_frames',
            'post_cond_video_frames', 'texts')


def _prime(opt):
    """Give every parameter of `opt` without state its initial state (what
    its first step would make), so a sharded load has tensors to fill."""
    for group in opt.param_groups:
        for p in group['params']:
            if opt.state[p]:
                continue
            if isinstance(opt, Adafactor):
                opt._init_state(p)
                continue
            fused = group.get('fused') or group.get('capturable')
            opt.state[p].update(
                step=torch.zeros((), dtype=torch.float32, device=p.device if fused else 'cpu'),
                exp_avg=torch.zeros_like(p, memory_format=torch.preserve_format),
                exp_avg_sq=torch.zeros_like(p, memory_format=torch.preserve_format))


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


def _min_shard_size(option):
    """The least leaf size that an `fsdp` / `shard_optimizer_states` option
    shards: the int given, or 2^15 for True (the JAX trainer's rule)."""
    return int(option) if isinstance(option, int) and not isinstance(option, bool) else 2 ** 15


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
    """Trains the unets of an `Imagen` one at a time, on the imagen's device.
    Built from an imagen, or from a self-describing checkpoint
    (`imagen_checkpoint_path`: its cascade and weights, built on `device`,
    None meaning the card, every unet's optimiser and EMA started from them)."""

    # one trainer a process when distributed, as the reference's (its trainer.py:256)
    locked = False

    def __init__(self, imagen=None, imagen_checkpoint_path=None, *, use_ema=True, lr=1e-4,
                 eps=1e-8, beta1=0.9, beta2=0.99, optimizer='adam', max_grad_norm=None,
                 weight_decay=0.0, group_wd_params=True, warmup_steps=None,
                 cosine_decay_max_steps=None, only_train_unet_number=None, fp16=False,
                 precision=None, split_batches=True,
                 dl_tuple_output_keywords_names=('images', 'text_embeds', 'text_masks',
                                                 'cond_images'),
                 split_valid_fraction=0.025, split_valid_from_train=False, split_random_seed=42,
                 checkpoint_path=None, checkpoint_every=None, checkpoint_fs=None, fs_kwargs=None,
                 max_checkpoints_keep=20, checkpoint_backend=None, mesh=None,
                 shard_optimizer_states=False, fsdp=False, sync_loss=True, seed=0, verbose=True,
                 device=None, **kwargs):
        ema_kwargs, kwargs = groupby_prefix_and_trim('ema_', kwargs)
        if kwargs:
            raise TypeError(f'ImagenTrainer got unexpected keyword arguments: {sorted(kwargs)}')
        unknown = set(ema_kwargs) - set(EMAConfig.__dataclass_fields__)
        if unknown:
            raise TypeError(f'ImagenTrainer got unexpected ema_ arguments: {sorted(unknown)}')
        if checkpoint_backend not in CHECKPOINT_BACKENDS:
            raise ValueError(f'unknown checkpoint_backend {checkpoint_backend!r}: None or '
                             "'msgpack' (one torch.save file) or 'orbax' (a sharded directory)")
        if exists(mesh) and not (isinstance(mesh, mesh_lib.DeviceMesh)
                                 and tuple(mesh.mesh_dim_names or ()) == mesh_lib.AXES):
            raise TypeError(f'mesh must be a DeviceMesh with axes {mesh_lib.AXES} '
                            f'(parallel.mesh.create_mesh), got {mesh!r}')
        if exists(imagen) == exists(imagen_checkpoint_path):
            raise ValueError('either pass an imagen instance or a checkpoint path')
        if exists(checkpoint_path) != exists(checkpoint_every):
            raise ValueError('checkpoint_path and checkpoint_every go together')
        if not 0 <= split_valid_fraction <= 1:
            raise ValueError(f'split_valid_fraction {split_valid_fraction} is not in [0, 1]')

        if self.is_distributed:
            if ImagenTrainer.locked:
                raise RuntimeError('ImagenTrainer can only be initialized once per process '
                                   'when distributed')
            ImagenTrainer.locked = True

        self.fs = get_fs(default(checkpoint_path, './'), checkpoint_fs, fs_kwargs)
        if not exists(imagen):
            imagen = load_imagen_from_checkpoint(imagen_checkpoint_path, device=device)

        self.imagen = imagen
        self.num_unets = imagen.num_unets
        self.device = imagen.device
        self.verbose = verbose
        self.sync_loss = sync_loss

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

        self.mesh = mesh
        self.fsdp = fsdp
        self.shard_optimizer_states = shard_optimizer_states
        self.checkpoint_backend = checkpoint_backend
        self.comm = MeshComm(mesh) if exists(mesh) else None
        self.layouts = [None] * self.num_unets

        self.optimizers = [None] * self.num_unets
        self.ema_unets = [None] * self.num_unets
        self.steps = np.zeros(self.num_unets, dtype=np.int64)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.step_timer = StepTimer()
        self._pending = None       # (index, weight) of forward() calls not yet applied
        self._ema_swapped = False
        self._save_executor = None
        self._pending_save = None
        self.prepared = False

        self.dl_tuple_output_keywords_names = dl_tuple_output_keywords_names
        self.train_dl = self.valid_dl = None
        self.train_dl_iter = self.valid_dl_iter = None
        self.split_valid_from_train = split_valid_from_train
        self.split_valid_fraction = split_valid_fraction
        self.split_random_seed = split_random_seed

        if exists(imagen_checkpoint_path):
            for i in range(self.num_unets):
                self._ensure_state(i)

        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self.max_checkpoints_keep = max_checkpoints_keep
        if exists(checkpoint_path):
            self.fs.makedirs(checkpoint_path, exist_ok=True)
            self.load_from_checkpoint_folder()

    @property
    def is_distributed(self):
        return dist.is_initialized() and dist.get_world_size() > 1

    @property
    def is_main(self):
        return not dist.is_initialized() or dist.get_rank() == 0

    is_local_main = is_main
    can_checkpoint = is_main

    def print(self, msg):
        if self.is_main and self.verbose:
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

    def print_untrained_unets(self):
        untrained = [i for i, (steps, unet) in enumerate(zip(self.steps, self.unets))
                     if steps == 0 and not isinstance(unet, NullUnet)]
        for i in untrained:
            self.print(f'unet {i + 1} has not been trained')
        if untrained:
            self.print('when sampling, pass stop_at_unet_number to stop early in the cascade, '
                       'so untrained unets are not used')

    def encode_text(self, text, **kwargs):
        """`text` through the cascade's T5 encoder, on its device."""
        return self.imagen.encode_text(text, **kwargs)

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

    def _make_optimizer(self, index, params=None, decays=None):
        """The optimiser of unet `index` over `params` (its trainable
        parameters by default), grouped by `decays` (whether each is decayed;
        `_decays` of each by default)."""
        params = default(params, lambda: self._params(index))
        decays = default(decays, lambda: [_decays(p) for p in params])
        wd = self.weight_decays[index]
        if self.group_wd_params:
            groups = [{'params': [p for p, d in zip(params, decays) if d], 'weight_decay': wd},
                      {'params': [p for p, d in zip(params, decays) if not d],
                       'weight_decay': 0.}]
        else:
            groups = [{'params': params, 'weight_decay': wd}]
        if self.optimizer_kinds[index] == 'adafactor':
            # the JAX trainer's optax.adafactor: beta2 is the exponent of the
            # second moment's decay schedule, beta1 the bf16 momentum; no eps
            return Adafactor(groups, lr=self.lrs[index], decay_rate=self.beta2,
                             momentum=self.beta1, blocks=self.layouts[index])
        return torch.optim.Adam(groups, lr=self.lrs[index], betas=(self.beta1, self.beta2),
                                eps=self.optim_eps[index],
                                fused=self.device.type == 'cuda')

    def _zero_enabled(self):
        return bool(self.shard_optimizer_states) and self._data_size() > 1

    def _fsdp_enabled(self):
        return bool(self.fsdp) and self._data_size() > 1

    def _data_size(self):
        return mesh_lib.axis_size(self.mesh, 'data') if exists(self.mesh) else 1

    def _placement_splits(self, unet):
        """Where the state of `unet` lives on the mesh: ({name: Split}s of its
        parameters and EMA, {name: Split}s of their optimiser state}, decided
        on the full parameters. Parameters: FSDP-cut over 'data' (and their
        columns over 'model' when the mesh has one), else columns over
        'model', else replicated. Optimiser state: the ZeRO layout under FSDP
        or ZeRO-1 (under FSDP it is the parameters' layout), else the
        parameters'."""
        if self._fsdp_enabled():
            params = mesh_lib.fsdp_sharding_rules(self.mesh, unet, _min_shard_size(self.fsdp))
        else:
            params = mesh_lib.param_sharding_rules(self.mesh, unet)
        if self._fsdp_enabled() or self._zero_enabled():
            option = self.fsdp if self._fsdp_enabled() else self.shard_optimizer_states
            opt = mesh_lib.zero_sharding_rules(self.mesh, unet, _min_shard_size(option))
        else:
            opt = params
        return ({k: splits_of(v) for k, v in params.items()},
                {k: splits_of(v) for k, v in opt.items()})

    def _ensure_state(self, index):
        """Make unet `index`'s optimiser and EMA; under a mesh first give
        every rank rank 0's weights and place the unet and its EMA copy."""
        if exists(self.optimizers[index]):
            return
        unet = self.unets[index]
        names = [n for n, p in unet.named_parameters() if p.requires_grad]
        decays = [_decays(p) for p in self._params(index)]
        if exists(self.mesh):
            mesh_lib.replicate(self.mesh, unet)
            layout = UnetLayout(self.comm, *self._placement_splits(unet))
        if self.use_ema:
            self.ema_unets[index] = copy.deepcopy(unet).requires_grad_(False)
        if not exists(self.mesh):
            self.optimizers[index] = self._make_optimizer(index, decays=decays)
            return
        layout.shard(unet)
        if self.use_ema:
            layout.shard(self.ema_unets[index])
        self.layouts[index] = layout
        self.optimizers[index] = self._make_optimizer(
            index, layout.optimizer_tensors(self._params(index), names), decays)

    def prepare(self):
        """Make the state of `only_train_unet_number` now (else at its first step)."""
        if self.prepared:
            raise RuntimeError('the trainer is already prepared')
        if exists(self.only_train_unet_number):
            self._ensure_state(self.only_train_unet_number - 1)
        self.prepared = True

    def _params(self, index):
        return [p for p in self.unets[index].parameters() if p.requires_grad]

    @torch.no_grad()
    def _clip_grads(self, grads, params=None, layout=None):
        """optax.clip_by_global_norm: g * min(1, max_norm / |g|), the norm over
        every gradient of the unet (under a mesh, over the ranks' blocks of
        the gradients of `params`)."""
        norms = torch.stack(torch._foreach_norm(grads))
        if exists(layout):
            norms = layout.global_norms(params, norms)
        norm = torch.linalg.vector_norm(norms)
        factor = (self.max_grad_norm / norm).clamp(max=1.)
        torch._foreach_mul_(grads, factor)

    def _apply_update(self, index):
        """Clip, decay, Adam and EMA on the gradients in `.grad` (under a mesh,
        averaged over the ranks first)."""
        if self._ema_swapped:
            raise RuntimeError('cannot take train steps inside use_ema_unets()')
        layout = self.layouts[index]
        params = self._params(index)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if exists(layout):
            layout.release(self.unets[index])
            layout.reduce_grads(params)
        if exists(self.max_grad_norm):
            self._clip_grads([p.grad for p in params], params, layout)
        opt = self.optimizers[index]
        lr = self._lr(index, int(self.steps[index]))
        for group in opt.param_groups:
            group['lr'] = lr
        if exists(layout):
            layout.before_step()
        opt.step()
        opt.zero_grad(set_to_none=True)
        if exists(layout):
            layout.after_step()
        self.steps[index] += 1
        if self.use_ema:
            unet, ema = self.unets[index], self.ema_unets[index]
            ema_update(self.ema_config, ema.parameters(), unet.parameters(),
                       int(self.steps[index]))

    # --- data ----------------------------------------------------------------------------

    def add_train_dataloader(self, dl=None):
        if not exists(dl):
            return
        if exists(self.train_dl):
            raise RuntimeError('training dataloader was already added')
        self.train_dl = dl

    def add_valid_dataloader(self, dl=None):
        if not exists(dl):
            return
        if exists(self.valid_dl):
            raise RuntimeError('validation dataloader was already added')
        self.valid_dl = dl

    def add_train_dataset(self, ds=None, *, batch_size, **dl_kwargs):
        """A `data.DataLoader` over `ds`; with `split_valid_from_train`, a
        `split_valid_fraction` of its rows (picked by `split_random_seed`) go
        to a validation loader instead."""
        if not exists(ds):
            return
        if exists(self.train_dl):
            raise RuntimeError('training dataloader was already added')
        valid_ds = None
        if self.split_valid_from_train:
            ds, valid_ds = split_dataset(ds, 1 - self.split_valid_fraction,
                                         seed=self.split_random_seed)
            self.print(f'training with dataset of {len(ds)} samples and validating with '
                       f'randomly splitted {len(valid_ds)} samples')
        self.add_train_dataloader(DataLoader(self._rank_rows(ds), batch_size=batch_size,
                                             **dl_kwargs))
        if self.split_valid_from_train:
            self.add_valid_dataset(valid_ds, batch_size=batch_size, **dl_kwargs)

    def add_valid_dataset(self, ds=None, *, batch_size, **dl_kwargs):
        if not exists(ds):
            return
        if exists(self.valid_dl):
            raise RuntimeError('validation dataloader was already added')
        self.add_valid_dataloader(DataLoader(self._rank_rows(ds), batch_size=batch_size,
                                             **dl_kwargs))

    def _rank_rows(self, ds):
        """Under a 'data' axis of n ranks, this rank's rows of `ds`: every n-th
        row from its 'data' coordinate, of the first n * (len // n), so each
        rank's loader reads as many rows, none of another's."""
        n = self._data_size()
        if n == 1:
            return ds
        from torch.utils.data import Subset
        return Subset(ds, range(self.mesh.get_local_rank('data'), len(ds) - len(ds) % n, n))

    def create_train_iter(self):
        if not exists(self.train_dl):
            raise RuntimeError('training dataloader not registered')
        if not exists(self.train_dl_iter):
            self.train_dl_iter = cycle(self.train_dl)

    def create_valid_iter(self):
        if not exists(self.valid_dl):
            raise RuntimeError('validation dataloader not registered')
        if not exists(self.valid_dl_iter):
            self.valid_dl_iter = cycle(self.valid_dl)

    def _batch_from_dl(self, dl_iter):
        """The next batch as a dict; a tuple is named by
        `dl_tuple_output_keywords_names`."""
        out = next(dl_iter)
        if isinstance(out, dict):
            return out
        return dict(zip(self.dl_tuple_output_keywords_names, cast_tuple(out)))

    def _prepare_batch(self, batch):
        """The batch's arrays and tensors on the device (None entries dropped,
        other entries, flags such as `ignore_time`, kept), `texts` encoded."""
        batch = {k: v for k, v in batch.items() if exists(v)}
        if 'texts' in batch and 'text_embeds' not in batch and self.imagen.condition_on_text:
            batch['text_embeds'], batch['text_masks'] = self.encode_text(
                batch.pop('texts'), return_attn_mask=True)
        batch = {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                 if isinstance(v, (torch.Tensor, np.ndarray)) else v for k, v in batch.items()}
        if exists(self.mesh):
            mesh_lib.check_rows(self.mesh, _batch_size(batch))
        return batch

    # --- training ------------------------------------------------------------------------

    def _check_trainable(self, unet_number):
        unet_number = self.validate_unet_number(unet_number)
        if exists(self.only_train_unet_number) and self.only_train_unet_number != unet_number:
            raise ValueError(f'you can only train unet #{self.only_train_unet_number}')
        return unet_number - 1

    def _chunk_losses(self, index, batch, max_batch_size):
        """(loss, weight) of each chunk of at most `max_batch_size` rows, made
        as it is asked for. The batch's tensors are split along their first
        axis; its other entries (a flag such as `ignore_time`) go to every chunk."""
        tensors = {k: v for k, v in batch.items() if isinstance(v, torch.Tensor)}
        options = {k: v for k, v in batch.items() if k not in tensors}
        for chunk, weight in _chunks(tensors, max_batch_size):
            chunk = dict(chunk)
            images = chunk.pop('images')
            with self._global_rows():
                loss = self.imagen(images, unet_number=index + 1, generator=self.generator,
                                   **chunk, **options)
            yield loss, weight

    def _global_rows(self):
        """Per-row draws over the global batch, keeping this rank's rows
        (`parallel/rows.py`); nothing without a 'data' axis."""
        if self._data_size() == 1:
            return nullcontext()
        return global_rows(self._data_size(), self.mesh.get_local_rank('data'))

    def _global_mean(self, loss):
        """The loss averaged over the 'data' ranks (each a mean over its rows)."""
        if self._data_size() == 1:
            return loss
        loss = torch.as_tensor(loss, device=self.device, dtype=torch.float32).clone()
        return self.comm.sum(loss, ('data',)) / self._data_size()

    def _backward(self, index, batch, max_batch_size, scale=1.):
        """Accumulate scale * d(loss)/d(params) into `.grad`; returns the loss."""
        self.unets[index].train()
        loss = 0.
        for chunk_loss, weight in self._chunk_losses(index, batch, max_batch_size):
            (chunk_loss * (weight * scale)).backward()
            loss = loss + chunk_loss.detach() * weight
        if exists(self.layouts[index]):
            self.layouts[index].release(self.unets[index])
        return loss

    def _loss_out(self, loss):
        """The global mean as a float, or with `sync_loss=False` the device
        scalar (no host sync)."""
        loss = self._global_mean(loss)
        return float(loss) if self.sync_loss else loss

    def train_step(self, *, unet_number=None, max_batch_size=None, **kwargs):
        """One optimiser step on the next batch of the train dataloader."""
        if not self.prepared:
            self.prepare()
        self.create_train_iter()
        batch = self._batch_from_dl(self.train_dl_iter)
        return self.step_with_batch(batch, unet_number=unet_number,
                                    max_batch_size=max_batch_size, **kwargs)

    def step_with_dl_iter(self, dl_iter, *, unet_number=None, max_batch_size=None, **kwargs):
        """One optimiser step on the next batch of `dl_iter`, a dict or a tuple
        named as the trainer's own dataloaders' are."""
        return self.step_with_batch(self._batch_from_dl(dl_iter), unet_number=unet_number,
                                    max_batch_size=max_batch_size, **kwargs)

    def step_with_batch(self, batch, *, unet_number=None, max_batch_size=None, **extra):
        """One optimiser step of unet `unet_number` on `batch` (a dict with
        'images' (b, h, w, c), or clips (b, f, h, w, c) for a video cascade,
        and, for a text-conditioned imagen, 'text_embeds' and optionally
        'text_masks', or 'texts'; a video cascade also takes
        'cond_video_frames', 'post_cond_video_frames' and 'ignore_time');
        returns the loss as a float (the device scalar with `sync_loss=False`),
        then writes a checkpoint into the folder when one is due."""
        if self._ema_swapped:
            raise RuntimeError('cannot take train steps inside use_ema_unets()')
        index = self._check_trainable(unet_number)
        if exists(self._pending):
            raise RuntimeError('forward() gradients are pending: call update() first')
        self._ensure_state(index)
        batch = self._prepare_batch({**batch, **extra})
        self.step_timer.start()
        loss = self._backward(index, batch, max_batch_size)
        self._apply_update(index)
        loss = self._loss_out(loss)
        self.step_timer.stop(self.device if self.sync_loss else None)
        self._maybe_checkpoint()
        return loss

    @torch.no_grad()
    def valid_step(self, *, unet_number=None, max_batch_size=None, use_ema_unets=False,
                   **kwargs):
        """The loss of unet `unet_number` (its EMA copy with `use_ema_unets`)
        on the next validation batch with no gradient (the loss runs the unet
        in train mode, dropout on, as the JAX trainer's validation loss
        does); chunks of at most `max_batch_size` rows weighted by their size."""
        if not self.prepared:
            self.prepare()
        self.create_valid_iter()
        batch = self._batch_from_dl(self.valid_dl_iter)
        index = self.validate_unet_number(unet_number) - 1
        self._ensure_state(index)
        batch = self._prepare_batch({**batch, **kwargs})
        unet = self.ema_unets[index] if use_ema_unets and self.use_ema else self.unets[index]
        online = self.unets[index]
        self.imagen.unets[index] = unet
        try:
            loss = sum(chunk_loss * weight for chunk_loss, weight in
                       self._chunk_losses(index, batch, max_batch_size))
        finally:
            self.imagen.unets[index] = online
        return self._loss_out(loss)

    def forward(self, *, unet_number=None, max_batch_size=None, **batch):
        """Loss and gradient without the optimiser step (follow with `update`).
        Calls before an update accumulate, weighted by batch size, so
        N x forward + update averages over every sample they saw."""
        index = self._check_trainable(unet_number)
        if exists(self._pending) and self._pending[0] != index:
            raise RuntimeError('accumulated forward() calls must target the same unet')
        self._ensure_state(index)
        batch = self._prepare_batch(batch)
        b = _batch_size(batch)
        loss = self._backward(index, batch, max_batch_size, scale=float(b))
        weight = (self._pending[1] if exists(self._pending) else 0) + b
        self._pending = (index, weight)
        return float(self._global_mean(loss))

    def update(self, unet_number=None):
        """Apply the gradients of the forward() calls since the last update,
        as their mean over every sample seen; then checkpoint when due."""
        index = self.validate_unet_number(unet_number) - 1
        if not exists(self._pending) or self._pending[0] != index:
            raise RuntimeError('call forward(...) before update()')
        weight = self._pending[1]
        self._pending = None
        grads = [p.grad for p in self._params(index) if p.grad is not None]
        torch._foreach_div_(grads, float(weight))
        self._apply_update(index)
        self._maybe_checkpoint()

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

    def get_ema_unet(self, unet_number=None):
        """The EMA copy of unet `unet_number`, or None without EMA."""
        if not self.use_ema:
            return None
        index = self.validate_unet_number(unet_number) - 1
        self._ensure_state(index)
        return self.ema_unets[index]

    def sample(self, *args, max_batch_size=None, use_non_ema=False, **kwargs):
        """`Imagen.sample` through the EMA unets (the online ones with
        `use_non_ema`), drawing from the trainer's generator by default;
        `video_frames` and the prompt frames pass through. With
        `max_batch_size`, every per-sample keyword is split into chunks of
        that many, sampled one after another and joined (lists of PIL images
        too, and each stage's output with `return_all_unet_outputs`)."""
        self.print_untrained_unets()
        kwargs.setdefault('generator', self.generator)
        batched = {k: kwargs[k] for k in _BATCHED
                   if exists(kwargs.get(k)) and hasattr(kwargs[k], '__len__')}
        b = max((len(v) for v in batched.values()), default=0)
        with self.use_ema_unets() if self.use_ema and not use_non_ema else nullcontext():
            if not exists(max_batch_size) or b <= max_batch_size:
                return self.imagen.sample(*args, **kwargs)
            outs = [self.imagen.sample(*args, **{**kwargs, **{
                        k: v[start:start + max_batch_size] for k, v in batched.items()}})
                    for start in range(0, b, max_batch_size)]
        pil = kwargs.get('return_pil_images', False)
        if kwargs.get('return_all_unet_outputs', False):
            return [[im for chunk in stage for im in chunk] if pil else torch.cat(stage)
                    for stage in zip(*outs)]
        if pil:
            return [im for out in outs for im in out]
        return torch.cat(outs)

    # --- checkpoints ---------------------------------------------------------------------

    def state_dict(self, without_optim_and_sched=False):
        """The JAX trainer's bundle: `model` (one state_dict per unet),
        `version`, `steps`, `optim{i}` and `ema`, every state made first, and
        `imagen_type` / `imagen_params` for an imagen built from a config.
        Under a mesh every block is gathered, so the bundle is a one-process
        trainer's whatever the layout (a collective: every rank calls it)."""
        for i in range(self.num_unets):
            self._ensure_state(i)
        return self._bundle(
            without_optim_and_sched,
            lambda i, m: self.layouts[i].full_state_dict(m) if self.layouts[i] else m.state_dict(),
            lambda i, o: (self.layouts[i].full_optimizer_state(o) if self.layouts[i]
                          else o.state_dict()))

    def _sharded_state(self, without_optim_and_sched=False):
        """The bundle with every block a DTensor sharing the live tensor's
        storage (see `utils/sharded_ckpt.py`); no gather."""
        for i in range(self.num_unets):
            self._ensure_state(i)
        return self._bundle(
            without_optim_and_sched,
            lambda i, m: (self.layouts[i].module_dtensors(m) if self.layouts[i] else
                          {k: v.detach() for k, v in m.state_dict(keep_vars=True).items()}),
            lambda i, o: (self.layouts[i].optimizer_dtensors(o) if self.layouts[i]
                          else o.state_dict()))

    def _bundle(self, without_optim_and_sched, module_state, optimizer_state):
        from imagen_tpu_torch.diffusion.elucidated import ElucidatedImagen
        bundle = dict(model=[module_state(i, u) for i, u in enumerate(self.unets)],
                      version=__version__, steps=np.array(self.steps))
        if not without_optim_and_sched:
            for i, opt in enumerate(self.optimizers):
                bundle[f'optim{i}'] = optimizer_state(i, opt)
        if self.use_ema:
            bundle['ema'] = [module_state(i, e) for i, e in enumerate(self.ema_unets)]
        if hasattr(self.imagen, '_config'):
            bundle['imagen_type'] = ('elucidated' if isinstance(self.imagen, ElucidatedImagen)
                                     else 'original')
            bundle['imagen_params'] = self.imagen._config
        return bundle

    def _load_module(self, index, module, state, strict):
        """Load a bundle's entry (the port's state_dict or JAX flax
        variables, whole) into `module`, this rank's blocks under a mesh."""
        from imagen_tpu_torch.utils.port_weights import state_dict_from_jax
        if isinstance(module, NullUnet):
            return
        video = self.imagen.is_video
        if is_flax_state(state):
            state = state_dict_from_jax(state, video=video)
        if exists(self.layouts[index]):
            state = self.layouts[index].local_state_dict(module, state)
        load_unet_state(module, state, strict=strict, video=video)

    def load_state_dict(self, bundle, only_model=False, strict=True):
        """Restore from a bundle of `state_dict`, or the model and EMA weights
        of a JAX trainer's bundle with `only_model`. `strict=False` loads the
        tensors whose names and shapes match and leaves the rest. Under a
        mesh every rank loads it, keeping its blocks."""
        models = as_list(bundle['model'])
        from_jax = any(is_flax_state(m) for m in models)
        if from_jax and not only_model:
            raise ValueError('this bundle was written by the JAX trainer: its optax optimizer '
                             'state does not carry across; load it with only_model=True for '
                             'its unet and EMA weights')
        for i in range(self.num_unets):
            self._ensure_state(i)
            self._load_module(i, self.unets[i], models[i], strict)
        if bundle.get('version') != __version__:
            self.print(f'loading checkpoint from version {bundle.get("version")}, '
                       f'current package version is {__version__}')
        if not (only_model and not from_jax):
            if not from_jax:
                self.steps = np.array(bundle['steps'], dtype=np.int64)
                for i, opt in enumerate(self.optimizers):
                    if f'optim{i}' in bundle:
                        state = bundle[f'optim{i}']
                        if exists(self.layouts[i]):
                            state = self.layouts[i].local_optimizer_state(opt, state)
                        opt.load_state_dict(state)
            if self.use_ema and 'ema' in bundle:
                for i, (ema, state) in enumerate(zip(self.ema_unets, as_list(bundle['ema']))):
                    self._load_module(i, ema, state, strict)
        for layout in self.layouts:
            if exists(layout):
                layout.resync()

    def save(self, path, overwrite=True, without_optim_and_sched=False, async_save=False,
             **kwargs):
        """Write the bundle (plus any extra `kwargs` entries) to `path`. The
        bundle is copied to the host first; with `async_save` a thread writes
        it while training goes on, and the next save or load waits for it.
        Under a mesh every rank calls it: every rank enters the gather and
        rank 0 writes; it returns once the file is written (the next save or
        load, with `async_save`). `checkpoint_backend='orbax'` writes a
        directory, each rank its blocks, with no gather."""
        path = str(path)
        self._wait_for_pending_save()
        if self.checkpoint_backend == 'orbax':
            from imagen_tpu_torch.utils.sharded_ckpt import save_bundle
            if not is_local_fs(self.fs):
                raise ValueError("checkpoint_backend='orbax' writes to the local filesystem, "
                                 f'not through the trainer\'s {type(self.fs).__name__}: save '
                                 "with checkpoint_backend='msgpack' to use it")
            if os.path.exists(path) and not overwrite:
                raise FileExistsError(f'{path} exists and overwrite is False')
            self._barrier()   # every rank has looked before rank 0 makes the directory
            bundle = {**self._sharded_state(without_optim_and_sched), **kwargs}
            self._pending_save = save_bundle(path, bundle, async_save=async_save)
            self.print(f'checkpoint saved to {path} (sharded)')
            return
        if self.fs.exists(path) and not overwrite:
            raise FileExistsError(f'{path} exists and overwrite is False')
        bundle = self.state_dict(without_optim_and_sched)
        if self.can_checkpoint:
            bundle = to_cpu({**bundle, **kwargs})
            if 'imagen_params' in bundle:
                self.print('this checkpoint is commandable from the CLI - '
                           f'"python -m imagen_tpu_torch.cli sample --model {path} \\"<prompt>\\""')
            if async_save:
                if self._save_executor is None:
                    from concurrent.futures import ThreadPoolExecutor
                    self._save_executor = ThreadPoolExecutor(max_workers=1)
                self._pending_save = self._save_executor.submit(save_obj, self.fs, path, bundle)
            else:
                save_obj(self.fs, path, bundle)
        if not async_save:
            self._barrier()
        self.print(f'checkpoint saved to {path}')

    def _barrier(self):
        if self.is_distributed:
            dist.barrier()

    def _wait_for_pending_save(self):
        """Wait for the writer of an `async_save`, raising what it raised; under
        a mesh, then for every rank."""
        pending, self._pending_save = self._pending_save, None
        if pending is not None:
            pending.result()
        self._barrier()

    def load(self, path, only_model=False, strict=True, noop_if_not_exist=False):
        """Restore from the bundle at `path` (the port's, or a JAX trainer's
        with `only_model`), its tensors placed on the imagen's device; every
        rank reads it. A sharded directory (`checkpoint_backend='orbax'`)
        is read block by block into the live trainer's placement (strict)."""
        self._wait_for_pending_save()
        path = str(path)
        if not self.fs.exists(path):
            if noop_if_not_exist:
                self.print(f'trainer checkpoint not found at {path}')
                return None
            raise FileNotFoundError(f'{path} does not exist')
        from imagen_tpu_torch.utils.sharded_ckpt import is_orbax_checkpoint
        if self.checkpoint_backend == 'orbax' or is_orbax_checkpoint(path):
            return self._load_sharded(path, only_model)
        bundle = load_obj(self.fs, path, map_location=self.device)
        self.load_state_dict(bundle, only_model=only_model, strict=strict)
        self.print(f'checkpoint loaded from {path}')
        return bundle

    def _load_sharded(self, path, only_model=False):
        """Each rank reads its blocks of a sharded directory in place."""
        from imagen_tpu_torch.utils.sharded_ckpt import load_bundle
        for i, opt in enumerate(self.optimizers):
            self._ensure_state(i)
            _prime(self.optimizers[i])
        target = self._sharded_state()
        if only_model:
            target = {'model': target['model']}
        loaded = load_bundle(path, target)
        if not only_model:
            self.steps = np.array(loaded['steps'], dtype=np.int64)
        for layout in self.layouts:
            if exists(layout):
                layout.resync()
        self.print(f'checkpoint loaded from {path} (sharded)')
        return loaded

    def reset_ema_unets_all_one_device(self, device=None):
        """Make every unet's state now. The reference uses this to undo its
        cascade's device juggling before a checkpoint; here the state already
        lives where `_placement_splits` puts it."""
        del device
        for i in range(self.num_unets):
            self._ensure_state(i)

    def print_unet_devices(self):
        """Log where each unet's (and EMA copy's) parameters live: the device
        and, under a mesh, how many of its tensors are this rank's blocks."""
        def placement(i, module):
            params = list(module.parameters()) if exists(module) else []
            if not params:
                return 'no parameters' if exists(module) else 'not made'
            layout = self.layouts[i]
            blocks = sum(p in layout.info for p in params) if exists(layout) else 0
            return f'{params[0].device}, {blocks} of {len(params)} tensors cut over the mesh'

        for i in range(self.num_unets):
            self.print(f'unet {i}: {placement(i, self.unets[i])}')
            if self.use_ema:
                self.print(f'ema unet {i}: {placement(i, self.ema_unets[i])}')

    # checkpoint folders: checkpoint.{total steps}.ckpt, the newest kept

    @property
    def all_checkpoints_sorted(self):
        """The folder's checkpoints, newest first (by the step count in the
        name, read as JAX does: the field before the last dot)."""
        checkpoints = self.fs.glob(os.path.join(str(self.checkpoint_path), 'checkpoint.*.ckpt'))
        return sorted(checkpoints, key=lambda x: int(str(x).split('.')[-2]), reverse=True)

    def load_from_checkpoint_folder(self, last_total_steps=-1):
        if last_total_steps != -1:
            self.load(os.path.join(str(self.checkpoint_path),
                                   f'checkpoint.{last_total_steps}.ckpt'))
            return
        checkpoints = self.all_checkpoints_sorted
        if not checkpoints:
            self.print(f'no checkpoints found to load from at {self.checkpoint_path}')
            return
        self.load(checkpoints[0])

    def save_to_checkpoint_folder(self):
        total_steps = int(self.steps.sum())
        self.save(os.path.join(str(self.checkpoint_path), f'checkpoint.{total_steps}.ckpt'))
        if self.max_checkpoints_keep <= 0 or not self.can_checkpoint:
            return
        for checkpoint in self.all_checkpoints_sorted[self.max_checkpoints_keep:]:
            self.fs.rm(checkpoint, recursive=True)   # a sharded checkpoint is a directory

    def _maybe_checkpoint(self):
        if not exists(self.checkpoint_path) or int(self.steps.sum()) % self.checkpoint_every:
            return
        self.save_to_checkpoint_folder()
