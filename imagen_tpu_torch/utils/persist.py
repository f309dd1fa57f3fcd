"""One unet's config and weights in one file; counterpart of
`imagen_tpu/utils/persist.py`.

The file records the unet's class, so a `Unet3D` comes back as a `Unet3D`,
with its constructor config and its `state_dict`. `hydrate_unet_from_file`
also reads a file that the JAX package's `persist_unet_to_file` wrote: its
flax variables go through `state_dict_from_jax`.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from imagen_tpu_torch.utils.checkpoint_io import (
    get_fs, load_obj, restore_index_dicts, save_obj, to_cpu)

_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16, 'float16': torch.float16}


def _unet_classes():
    from imagen_tpu_torch.models.unet2d import NullUnet, Unet
    from imagen_tpu_torch.models.unet3d import Unet3D
    return {'Unet': Unet, 'Unet3D': Unet3D, 'NullUnet': NullUnet}


def unet_to_config(unet):
    """The unet's constructor config as a JSON-able dict (dtype by name)."""
    from imagen_tpu_torch.models.unet2d import NullUnet
    if isinstance(unet, NullUnet):
        return dict(lowres_cond=unet.lowres_cond, channels=unet.channels)
    config = dict(unet._config)
    if 'dtype' in config:
        config['dtype'] = str(config['dtype']).removeprefix('torch.')
    return config


def unet_from_config(klass, config, device=None):
    """`klass(**config)` on `device`, the config as `unet_to_config` (or the
    JAX package) wrote it: lists become tuples, dtype names dtypes."""
    config = dict(restore_index_dicts(config))
    if isinstance(config.get('dtype'), str):
        config['dtype'] = _DTYPES[config['dtype']]
    config = {k: tuple(v) if isinstance(v, list) else v for k, v in config.items()}
    return klass(**config, device=device)


def persist_unet_to_file(unet, path, fs=None):
    """Save `unet`'s class, config and `state_dict` to `path`."""
    fs = get_fs(path, fs)
    if '://' not in str(path):
        Path(str(path)).parent.mkdir(exist_ok=True, parents=True)
    save_obj(fs, path, dict(unet_class=type(unet).__name__, config=unet_to_config(unet),
                            state_dict=to_cpu(unet.state_dict())))


def hydrate_unet_from_file(path, fs=None, device=None):
    """The unet that `path` holds, built on `device` (None: the card) with its weights."""
    from imagen_tpu_torch.utils.port_weights import state_dict_from_jax
    pkg = load_obj(get_fs(path, fs), path, map_location='cpu')
    if 'config' not in pkg or 'state_dict' not in pkg:
        raise ValueError(f'{path} is not a persisted unet (no config or state_dict)')
    name = pkg.get('unet_class', 'Unet')
    unet = unet_from_config(_unet_classes()[name], pkg['config'], device=device)
    state = pkg['state_dict']
    if name == 'NullUnet':
        return unet
    if any(isinstance(v, np.ndarray) for v in _leaves(state)):   # flax variables
        state = state_dict_from_jax(state, video=name == 'Unet3D')
    unet.load_state_dict(state, strict=True)
    return unet


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
