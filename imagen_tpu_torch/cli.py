"""Command line: `imagen config | train | sample`; counterpart of
`imagen_tpu/cli.py`, with the same commands, options and config keys.

    python -m imagen_tpu_torch.cli config --path imagen_config.json
    python -m imagen_tpu_torch.cli train --config imagen_config.json --unet 1
    python -m imagen_tpu_torch.cli sample --model imagen.ckpt "a prompt"

(`imagen_torch` once the package is installed.) Models run on the card;
`--device cpu` asks for the CPU. A config whose trainer has a `parallel`
block trains on several GPUs, one process each:

    torchrun --nproc-per-node 8 -m imagen_tpu_torch.cli train --config c.json

Each rank joins the process group (NCCL; gloo with `--device cpu`).
`train` reads its HF dataset (`datasets`) and encodes captions with T5
(`transformers`), both imported when it runs.
"""
from __future__ import annotations

import json
import pkgutil
import re
from pathlib import Path

import click

from imagen_tpu_torch.version import __version__

_CHANNEL_MODES = {1: 'L', 2: 'LA', 3: 'RGB', 4: 'RGBA'}


def simple_slugify(text: str, max_length=255):
    """Filesystem-safe name for a prompt string."""
    slug = re.sub(r'[,]+', '', text)
    slug = re.sub(r'\|', '--', slug)
    slug = re.sub(r'[-\s]+', '_', slug)
    return slug.strip('-_./\\')[:max_length]


def _require(path_str: str, kind: str) -> Path:
    p = Path(path_str)
    if not p.exists():
        raise click.ClickException(f'{kind} does not exist: {p.resolve()}')
    return p


@click.group()
def imagen():
    pass


@imagen.command(help='Sample from an Imagen model checkpoint')
@click.option('--model', default='./imagen.ckpt', help='path to trained Imagen model')
@click.option('--cond_scale', default=5., help='classifier-free guidance scale')
@click.option('--load_ema', default=True, help='load EMA version of unets if available')
@click.option('--device', default=None, help='torch device (default: the card)')
@click.argument('text')
def sample(model, cond_scale, load_ema, device, text):
    import torch

    from imagen_tpu_torch.utils.checkpoint_io import get_fs, load_obj
    from imagen_tpu_torch.utils.load import load_imagen_from_checkpoint, safeget

    model_path = _require(model, 'checkpoint')
    ckpt_version = safeget(load_obj(get_fs(model), model, map_location='cpu'), 'version')
    if ckpt_version != __version__:
        click.echo(f'note: checkpoint was written by version {ckpt_version}; '
                   f'this is {__version__}')
    click.echo(f'restoring cascade from {model_path.resolve()}')

    imagen_model = load_imagen_from_checkpoint(str(model_path), load_ema_if_available=load_ema,
                                               device=device).eval()
    pil_images = imagen_model.sample(
        texts=[text], cond_scale=cond_scale, return_pil_images=True,
        generator=torch.Generator(device=imagen_model.device).manual_seed(0))

    out = Path(f'./{simple_slugify(text)}.png')
    pil_images[0].save(out)
    click.echo(f'wrote {out}')


@imagen.command(help='Generate a config for the Imagen model')
@click.option('--path', default='./imagen_config.json', help='config output path')
def config(path):
    data = pkgutil.get_data('imagen_tpu_torch', 'default_config.json').decode('utf-8')
    Path(path).write_text(data)


# --- train ---------------------------------------------------------------------------------

def _load_train_config(config_file):
    cfg = json.loads(_require(config_file, 'config').read_text())
    if 'checkpoint_path' not in cfg:
        raise click.ClickException('config is missing "checkpoint_path"')
    if 'batch_size' not in cfg.get('dataset', {}):
        raise click.ClickException('config is missing dataset.batch_size')
    return cfg


def _join_process_group(device=None):
    """Join the process group a config's 'parallel' block lays its mesh over,
    unless this process has joined one: under `torchrun` the environment
    holds the rank, the world size and the address. NCCL on the card, gloo
    when `device` is the CPU. True when this call joined it."""
    import torch
    import torch.distributed as dist

    from imagen_tpu_torch.parallel.mesh import initialize_distributed

    if dist.is_initialized():
        return False
    on_cpu = device is not None and torch.device(device).type == 'cpu'
    initialize_distributed(backend='gloo' if on_cpu else 'nccl')
    return True


def _build_trainer(cfg, device=None):
    """(imagen, trainer, checkpoint path) of a config file's dict; resumes
    from the checkpoint when it exists. A 'parallel' block lays the trainer
    out on the process group's mesh (under torchrun every rank builds it;
    rank 0 prints and writes), joining the group first if need be."""
    from imagen_tpu_torch.configs import ElucidatedImagenConfig, ImagenConfig, apply_parallel
    from imagen_tpu_torch.trainer import ImagenTrainer

    trainer_kwargs = dict(cfg.get('trainer', {}))
    if trainer_kwargs.get('parallel') is not None:
        _join_process_group(device)
    klass = ElucidatedImagenConfig if cfg['type'] == 'elucidated' else ImagenConfig
    model = klass(**cfg['imagen']).create(device=device)
    trainer = ImagenTrainer(imagen=model, **apply_parallel(trainer_kwargs, device=device))

    ckpt = Path(cfg['checkpoint_path'])
    if ckpt.exists():
        if trainer.is_main:
            click.echo(f'resuming from {ckpt}')
        trainer.load(str(ckpt))
    return model, trainer, ckpt


def _pick_split(ds):
    """train + valid if both exist, else whichever is there, else the dataset."""
    have = [name for name in ('train', 'valid') if name in ds]
    if len(have) == 2:
        from datasets import concatenate_datasets
        return concatenate_datasets([ds['train'], ds['valid']])
    if have:
        return ds[have[0]]
    return ds


def _register_dataset(cfg, model, trainer, unet, device):
    from datasets import load_dataset

    from imagen_tpu_torch.data import Collator

    n_channels = cfg['imagen'].get('channels', 3)
    if n_channels not in _CHANNEL_MODES:
        raise click.ClickException(f'channels must be 1..4 (L/LA/RGB/RGBA), got {n_channels}')

    trainer.add_train_dataset(
        ds=_pick_split(load_dataset(cfg['dataset_name'])),
        collate_fn=Collator(
            image_size=cfg['imagen']['image_sizes'][unet - 1],
            image_label=cfg['image_label'],
            text_label=cfg['text_label'],
            url_label=cfg['url_label'],
            name=model.text_encoder_name,
            channels=_CHANNEL_MODES[n_channels],
            # T5 goes where the collator runs: a loader worker must not touch CUDA
            device='cpu' if cfg['dataset'].get('num_workers') else device,
        ),
        **cfg['dataset'],
    )


class _Cadence:
    """'do X every N epochs (skipping epoch 0)' for the config's *_at_every keys."""

    def __init__(self, every, enabled=True):
        self.every = every or 0
        self.enabled = enabled and self.every > 0

    def hits(self, epoch):
        return self.enabled and epoch > 0 and epoch % self.every == 0


@imagen.command(help='Train the Imagen model')
@click.option('--config', 'config_file', default='./imagen_config.json',
              help='Path to the Imagen model config')
@click.option('--unet', default=1, help='Unet to train',
              type=click.IntRange(1, 3, False, True, True))
@click.option('--epoches', default=50, help='Amount of epoches to train for')
@click.option('--device', default=None, help='torch device (default: the card)')
def train(config_file, unet, epoches, device):
    import torch.distributed as dist
    from tqdm import tqdm

    had_group = dist.is_initialized()
    cfg = _load_train_config(config_file)
    model, trainer, ckpt = _build_trainer(cfg, device=device)
    _register_dataset(cfg, model, trainer, unet, device)

    max_batch_size = cfg.get('max_batch_size', 1)
    sample_texts = cfg.get('sample_texts', [])

    validate = _Cadence(cfg.get('validate_at_every'), enabled=trainer.split_valid_from_train)
    sample_every = _Cadence(cfg.get('sample_at_every'), enabled=bool(sample_texts))
    save_every = _Cadence(cfg.get('save_at_every'))
    if 'sample_at_every' in cfg and not sample_texts:
        raise click.ClickException('sample_at_every is set but sample_texts is empty')

    steps_per_epoch = len(trainer.train_dl)
    for epoch in range(epoches):
        bar = tqdm(range(steps_per_epoch), desc=f'epoch {epoch}', disable=not trainer.is_main)
        for _ in bar:
            loss = trainer.train_step(unet_number=unet, max_batch_size=max_batch_size)
            bar.set_postfix(loss=f'{loss:.4f}')

        if validate.hits(epoch):
            valid_loss = trainer.valid_step(unet_number=unet, max_batch_size=max_batch_size)
            if trainer.is_main:
                click.echo(f'epoch {epoch}: valid loss {valid_loss:.4f}')

        if sample_every.hits(epoch):
            images = trainer.sample(texts=sample_texts, batch_size=1, return_pil_images=True,
                                    stop_at_unet_number=unet)
            if trainer.is_main:
                images[0].save(f'./sample-{epoch // 100}.png')

        if save_every.hits(epoch):
            trainer.save(str(ckpt))

    trainer.save(str(ckpt))
    if dist.is_initialized() and not had_group:
        dist.destroy_process_group()


if __name__ == '__main__':
    imagen()
