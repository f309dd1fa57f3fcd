"""Rebuild a cascade from a self-describing checkpoint alone; counterpart of
`imagen_tpu/utils/load.py`.

The checkpoint may be the port's trainer bundle or one the JAX package's
trainer wrote (flax msgpack): the cascade is built from its `imagen_type`
and `imagen_params`, and its `model` weights (or `ema`, given
`load_ema_if_available`) are loaded into the unets, the JAX ones through
`state_dict_from_jax` with `strict=True`.
"""
from __future__ import annotations

from functools import reduce

import numpy as np

from imagen_tpu_torch.utils.checkpoint_io import as_list, get_fs, load_obj, restore_index_dicts
from imagen_tpu_torch.utils.helpers import exists


def safeget(dictionary, keys, default=None):
    """Dotted-path dict get."""
    return reduce(lambda d, key: d.get(key, default) if isinstance(d, dict) else default,
                  keys.split('.'), dictionary)


def is_flax_state(state):
    """True for the JAX package's unet state (nested dicts of numpy arrays),
    False for a `state_dict` of tensors."""
    if isinstance(state, dict):
        return any(is_flax_state(v) for v in state.values())
    return isinstance(state, np.ndarray)


def load_unet_state(unet, state, strict=True, video=False):
    """Load one unet's entry of a bundle, the port's `state_dict` or the JAX
    package's flax variables (`video` picks the `Unet3D` table). `strict=False`
    loads the tensors whose names and shapes match and leaves the rest. A
    `NullUnet` has nothing to load (the JAX bundle's entry for it is empty)."""
    from imagen_tpu_torch.models.unet2d import NullUnet
    from imagen_tpu_torch.utils.port_weights import state_dict_from_jax
    if isinstance(unet, NullUnet):
        return
    if is_flax_state(state):
        state = state_dict_from_jax(state, video=video)
    if not strict:
        own = unet.state_dict()
        state = {k: v for k, v in state.items() if k in own and own[k].shape == v.shape}
    unet.load_state_dict(state, strict=strict)


def imagen_from_bundle(bundle, device=None):
    """The cascade that a bundle's `imagen_type` and `imagen_params` describe,
    with fresh weights, on `device` (None: the card)."""
    from imagen_tpu_torch.configs import ElucidatedImagenConfig, ImagenConfig
    imagen_params = restore_index_dicts(safeget(bundle, 'imagen_params'))
    imagen_type = safeget(bundle, 'imagen_type')
    klass = {'original': ImagenConfig, 'elucidated': ElucidatedImagenConfig}.get(imagen_type)
    if klass is None or not exists(imagen_params):
        raise ValueError(f'unknown imagen type {imagen_type} - checkpoint is not '
                         'self-describing (imagen type and configuration must be saved in it)')
    return klass(**imagen_params).create(device=device)


def load_imagen_from_checkpoint(checkpoint_path, load_weights=True,
                                load_ema_if_available=False, fs=None, device=None):
    """The cascade of `checkpoint_path` on `device` (None: the card), with its
    weights (the EMA ones if `load_ema_if_available` and it has them) unless
    `load_weights` is False."""
    bundle = load_obj(get_fs(checkpoint_path, fs), checkpoint_path, map_location='cpu')
    imagen = imagen_from_bundle(bundle, device=device)
    if not load_weights:
        return imagen
    source = bundle['ema'] if load_ema_if_available and 'ema' in bundle else bundle['model']
    for unet, state in zip(imagen.unets, as_list(source)):
        load_unet_state(unet, state, video=imagen.is_video)
    return imagen
