"""Sharded checkpoints through `torch.distributed.checkpoint`; counterpart of
`imagen_tpu/utils/orbax_ckpt.py` (named for what it does: it uses no orbax).

The default bundle (`trainer.save`) gathers every block to every rank
before rank 0 writes it, so one host holds the whole parameter and
optimiser state: what FSDP exists to avoid. Here each rank writes only its
blocks (DTensors of the live trainer's placement) and a load reads each
block back into the tensor that holds it, with no gather. The directory is
the JAX backend's layout: `<dir>/arrays/` (the tensors, one file a rank
and `.metadata`) and `<dir>/meta.json` (version and the self-describing
config strings), written by rank 0. Every rank calls `save_bundle` and
`load_bundle`.

A directory the JAX package's orbax backend wrote (tensorstore, read only
through orbax) is refused with an error that points to its msgpack bundle,
which the port reads (`trainer.load(path, only_model=True)`).
"""
from __future__ import annotations

import json
import os

import torch.distributed as dist
import torch.distributed.checkpoint as dcp

META_KEYS = ('version', 'imagen_type', 'imagen_params')
_DCP_METADATA = '.metadata'


def _str_keys(tree):
    """Nested dicts and lists with every key a string (lists become {'0': ...}),
    the form the checkpoint's flat names are made from."""
    if isinstance(tree, dict):
        return {str(k): _str_keys(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and any(isinstance(v, (dict, list, tuple)) for v in tree):
        return {str(i): _str_keys(v) for i, v in enumerate(tree)}
    return tree


def _keep(tree, names, prefix=''):
    """`tree` with only the leaves whose flat names are in `names`."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        name = f'{prefix}{k}'
        if isinstance(v, dict):
            kept = _keep(v, names, name + '.')
            if kept:
                out[k] = kept
        elif name in names:
            out[k] = v
    return out


def _is_main():
    return not dist.is_initialized() or dist.get_rank() == 0


def is_orbax_checkpoint(path):
    """Whether `path` is a sharded checkpoint directory (this module's or the
    JAX package's: a directory holding `arrays/`)."""
    p = os.path.abspath(str(path))
    return os.path.isdir(p) and os.path.isdir(os.path.join(p, 'arrays'))


def _arrays(path):
    arrays = os.path.join(os.path.abspath(str(path)), 'arrays')
    if not os.path.exists(os.path.join(arrays, _DCP_METADATA)):
        raise ValueError(
            f'{path} is not a sharded checkpoint of this package: a directory the JAX package\'s '
            "orbax backend wrote (tensorstore) cannot be read without orbax. Save that trainer "
            "with checkpoint_backend='msgpack' and load the bundle with "
            'trainer.load(path, only_model=True)')
    return arrays


def save_bundle(path, bundle, *, async_save=False):
    """Write a trainer bundle whose blocks are DTensors (each rank writes its
    own; tensors that every rank holds alike are written once). Collective.
    Returns the write's future with `async_save` (call `.result()` before
    exiting), else None."""
    path = os.path.abspath(str(path))
    meta = {k: bundle[k] for k in META_KEYS if k in bundle}
    arrays = _str_keys({k: v for k, v in bundle.items() if k not in meta})
    if _is_main():
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, 'meta.json'), 'w') as f:
            json.dump(meta, f, default=str)
    if dist.is_initialized():
        dist.barrier()
    target = os.path.join(path, 'arrays')
    if async_save:
        return dcp.async_save(arrays, checkpoint_id=target)
    dcp.save(arrays, checkpoint_id=target)
    return None


def saved_keys(path):
    """The flat names of the tensors and values saved (no data is read)."""
    return set(dcp.FileSystemReader(_arrays(path)).read_metadata().state_dict_metadata)


def load_bundle(path, target):
    """Read a bundle into `target`, a tree of the same form as the one saved
    whose tensors (DTensors for blocks) are filled in place, each rank its
    blocks; entries that the checkpoint does not hold are left out. Returns
    the tree read, with the meta entries. Collective."""
    arrays = _arrays(path)
    target = _keep(_str_keys(target), saved_keys(path))
    dcp.load(target, checkpoint_id=arrays)
    meta_path = os.path.join(os.path.abspath(str(path)), 'meta.json')
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return {**target, **meta}
