"""Checkpoint byte IO; counterpart of `imagen_tpu/utils/checkpoint_io.py`.

- `get_fs`: a local path gets `LocalFS`, a small object with the methods the
  trainer uses (`exists`, `glob`, `rm`, `makedirs`, `open`); a URL (or
  `fs_kwargs`) gets an fsspec filesystem, imported only then; a given `fs`
  is used as it is. `is_local_fs` tells the local filesystem (`LocalFS` or
  fsspec's) from others.
- `save_obj` / `load_obj`: the port's bundles are `torch.save` files.
  `load_obj` also reads the JAX package's flax-msgpack bundles, decoded here
  with `msgpack` (`read_flax_msgpack`): flax's ext types (ndarray, complex,
  numpy scalar) and its chunked arrays, bfloat16 widened to float32. No
  flax import.
- `restore_index_dicts`: msgpack bundles store lists as {'0': ..., '1': ...}.
"""
from __future__ import annotations

import glob as _glob
import os
import shutil

import numpy as np
import torch

from imagen_tpu_torch.utils.helpers import cast_tuple, default


class LocalFS:
    """The local filesystem, with the fsspec methods the trainer calls."""

    def exists(self, path):
        return os.path.exists(str(path))

    def glob(self, pattern):
        return sorted(_glob.glob(str(pattern)))

    def rm(self, path, recursive=False):
        if recursive and os.path.isdir(str(path)):
            shutil.rmtree(str(path))
        else:
            os.remove(str(path))

    def makedirs(self, path, exist_ok=False):
        os.makedirs(str(path), exist_ok=exist_ok)

    def open(self, path, mode='rb'):
        return open(str(path), mode)


def get_fs(path_or_url, fs=None, fs_kwargs=None):
    """`fs` if given; fsspec's filesystem for a URL or given `fs_kwargs`;
    else `LocalFS`."""
    if fs is not None:
        return fs
    if '://' in str(path_or_url) or fs_kwargs:
        from fsspec.core import url_to_fs
        return url_to_fs(str(path_or_url), **default(fs_kwargs, {}))[0]
    return LocalFS()


def is_local_fs(fs):
    """Whether `fs` is the local filesystem: `LocalFS`, or fsspec's."""
    return isinstance(fs, LocalFS) or 'file' in cast_tuple(getattr(fs, 'protocol', ()))


def to_cpu(obj):
    """A copy of `obj` with every tensor cloned to the host (containers rebuilt),
    so later in-place updates on the device do not reach it."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to('cpu', copy=True)
    if isinstance(obj, np.ndarray):
        return obj.copy()
    if isinstance(obj, dict):
        return type(obj)((k, to_cpu(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_cpu(v) for v in obj)
    return obj


def save_obj(fs, path, obj):
    """torch.save `obj` to `path` through `fs`."""
    with fs.open(str(path), 'wb') as f:
        torch.save(obj, f)


def load_obj(fs, path, map_location=None):
    """Load a bundle: a `torch.save` file (a zip archive, tensors placed by
    `map_location`), or a JAX package's flax-msgpack bundle (nested dicts of
    numpy arrays)."""
    with fs.open(str(path), 'rb') as f:
        is_zip = f.read(2) == b'PK'
        f.seek(0)
        if not is_zip:
            return read_flax_msgpack(f.read())
        # the bundles hold numpy step counts and configs besides tensors
        return torch.load(f, map_location=map_location, weights_only=False)


# --- flax msgpack ------------------------------------------------------------------------

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


def _ndarray_from_bytes(data):
    import msgpack
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b'bfloat16':
        # bf16 is the top half of an fp32: widen it exactly
        bits = np.frombuffer(buffer, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape).copy()


def _ext_hook(code, data):
    import msgpack
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_COMPLEX:
        real, imag = msgpack.unpackb(data)
        return complex(real, imag)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def _unchunk(obj):
    """flax splits arrays past 1 GiB into {'__msgpack_chunked_array__', 'shape',
    'chunks'} dicts; join them back."""
    if not isinstance(obj, dict):
        return obj
    if '__msgpack_chunked_array__' in obj:
        shape = tuple(obj['shape'][str(i)] for i in range(len(obj['shape'])))
        chunks = [obj['chunks'][str(i)] for i in range(len(obj['chunks']))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in obj.items()}


def read_flax_msgpack(data):
    """Decode `flax.serialization.msgpack_serialize` bytes into nested dicts of
    numpy arrays and Python values, as `msgpack_restore` does."""
    import msgpack
    return _unchunk(msgpack.unpackb(data, ext_hook=_ext_hook, raw=False))


def restore_index_dicts(obj):
    """Turn msgpack's list dicts {'0': ..., '1': ...} back into lists, recursively
    (for the JSON-like config payloads riding in a bundle)."""
    if isinstance(obj, dict):
        if obj and all(isinstance(k, str) and k.isdigit() for k in obj):
            return [restore_index_dicts(obj[str(i)]) for i in range(len(obj))]
        return {k: restore_index_dicts(v) for k, v in obj.items()}
    return obj


def as_list(maybe_dict):
    """A list stored by msgpack as {'0': ..., '1': ...}, or a list, as a list."""
    if isinstance(maybe_dict, dict) and all(k.isdigit() for k in maybe_dict):
        return [maybe_dict[str(i)] for i in range(len(maybe_dict))]
    return list(maybe_dict)
