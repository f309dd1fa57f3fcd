"""A checkout root with one tiny cell, for the CPU tests of the harness.

The tiny configuration is `imagen-64-256` with every width cut so that a
run takes seconds on the CPU; the data files it needs are written fresh and
the system adapters and metric readers are copied from the real benchmark, so the
harness finds them by name as it finds the real ones.
"""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from port_bench import registry

REAL = registry.ROOT / 'port_bench'


def tiny_config(compute_dtype='float32'):
    config = copy.deepcopy(registry.config('imagen-64-256'))
    config['unets'][0].update(dim=16, attn_heads=2, attn_dim_head=8, num_resnet_blocks=1)
    config['unets'][1].update(dim=8, attn_heads=2, attn_dim_head=8,
                              num_resnet_blocks=[1, 1, 1, 1])
    config.update(name='tiny', image_sizes=[16, 32], timesteps=[3, 2], text_embed_dim=12,
                  max_text_len=6, compute_dtype=compute_dtype)
    return config


def tiny_mix():
    return dict(registry.traffic('cascade-b8'), prompts=2, tokens_min=2, tokens_max=6,
                check_from=2, check_requests=1, trace_requests=1)


def tiny_sr_config(compute_dtype='float32'):
    """The SR-1024 configuration's shape: a NullUnet, then a super-resolution
    U-Net without attention at its levels, from 8 px to 32 px."""
    config = tiny_config(compute_dtype)
    config['unets'][0] = {'unet': 'NullUnet'}
    config['unets'][1]['layer_attns'] = False
    config.update(image_sizes=[8, 32], timesteps=[2, 3])
    return config


def tiny_sr_mix():
    return dict(registry.traffic('sr-start-b1'), tokens_min=2, tokens_max=6, start_image_size=8,
                check_from=2, check_requests=1, trace_requests=1)


KINDS = {'cascade': (tiny_config, tiny_mix), 'sr': (tiny_sr_config, tiny_sr_mix)}


def write(path, data):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(data, indent=1))


def make_root(tmp, compute_dtype='float32', step_rms_limit=1e-4, kind='cascade'):
    """A root with BENCHMARK.json naming one cell, `tiny-serve`, and its files:
    a tiny cascade served by the server, or (`kind='sr'`) a tiny last stage
    sampled from a start image."""
    make_config, make_mix = KINDS[kind]
    root = Path(tmp)
    bench = registry.benchmark()
    bench['configs'] = [dict(bench['configs'][0], name='tiny',
                             file='port_bench/configs/tiny.json')]
    bench['workloads'] = [dict(name='tiny-serve', config='tiny', traffic='tiny', chips=1,
                               why='a tiny cascade for the CPU tests')]
    for m in bench['per_layer']:
        m['workloads'] = ['tiny-serve']
    write(root / 'BENCHMARK.json', bench)
    write(root / 'port_bench' / 'configs' / 'tiny.json', make_config(compute_dtype))
    write(root / 'port_bench' / 'traffic' / 'tiny.json', make_mix())
    write(root / 'port_bench' / 'cells' / 'tiny-serve.json',
          dict(limits=dict(start=dict(limit=0.), answer=dict(limit=0.),
                           step_rms=dict(limit=step_rms_limit))))
    for folder in ('metrics', 'systems'):
        shutil.copytree(REAL / folder, root / 'port_bench' / folder,
                        ignore=shutil.ignore_patterns('__pycache__'))
    return root


def tiny_train_mix():
    """The training mix at the tiny size: 4 rows of 16 px, the EMA's first
    update with a decay above 0 at step 4."""
    return dict(registry.traffic('train-b32'), prompts=4, tokens_min=2, tokens_max=6,
                start_image_size=16, trace_requests=2, reference_rows=3,
                train=dict(registry.traffic('train-b32')['train'],
                           ema=dict(update_after_step=1, update_every=2)))


TRAIN_LIMITS = dict(draws=0., change=0.1, late_loss=1e-5, late_grad_median=1e-3, late_change=0.1,
                    ema=1e-5)


def make_train_root(tmp, limits=TRAIN_LIMITS):
    """A root with BENCHMARK.json naming one training cell, `tiny-train`: the
    tiny configuration's first U-Net trained in float32 on the tiny mix."""
    root = Path(tmp)
    bench = registry.benchmark()
    bench['configs'] = [dict(bench['configs'][0], name='tiny',
                             file='port_bench/configs/tiny.json')]
    bench['workloads'] = [dict(name='tiny-train', config='tiny', traffic='tiny', chips=1,
                               why='a tiny training step for the CPU tests')]
    for m in bench['per_layer']:
        m['workloads'] = ['tiny-train']
    write(root / 'BENCHMARK.json', bench)
    write(root / 'port_bench' / 'configs' / 'tiny.json', tiny_config())
    write(root / 'port_bench' / 'traffic' / 'tiny.json', tiny_train_mix())
    write(root / 'port_bench' / 'cells' / 'tiny-train.json',
          dict(limits={k: dict(limit=v) for k, v in limits.items()}))
    for folder in ('metrics', 'systems'):
        shutil.copytree(REAL / folder, root / 'port_bench' / folder,
                        ignore=shutil.ignore_patterns('__pycache__'))
    return root
