"""Pure-python helper utilities; counterpart of `imagen_tpu/utils/helpers.py`.

Config-time helpers only; tensor-touching helpers live in
`imagen_tpu_torch.ops.tensor_utils`.
"""
from functools import wraps


def exists(val):
    return val is not None


def default(val, d):
    if exists(val):
        return val
    return d() if callable(d) else d


def identity(t, *args, **kwargs):
    return t


def divisible_by(numer, denom):
    return (numer % denom) == 0


def first(arr, d=None):
    if len(arr) == 0:
        return d
    return arr[0]


def maybe(fn):
    """`fn` that passes None through."""
    @wraps(fn)
    def inner(x):
        if not exists(x):
            return x
        return fn(x)
    return inner


def once(fn):
    """`fn` that runs on its first call only."""
    called = False

    @wraps(fn)
    def inner(x):
        nonlocal called
        if called:
            return
        called = True
        return fn(x)
    return inner


def cast_tuple(val, length=None):
    if isinstance(val, list):
        val = tuple(val)

    output = val if isinstance(val, tuple) else ((val,) * default(length, 1))

    if exists(length) and len(output) != length:
        raise ValueError(
            f'tuple of length {len(output)} does not match expected length {length}')

    return output


def compact(input_dict):
    return {key: value for key, value in input_dict.items() if exists(value)}


def maybe_transform_dict_key(input_dict, key, fn):
    """A copy of `input_dict` with `fn` applied to its `key`, if it has it."""
    if key not in input_dict:
        return input_dict
    copied_dict = input_dict.copy()
    copied_dict[key] = fn(copied_dict[key])
    return copied_dict


def pad_tuple_to_length(t, length, fillvalue=None):
    remain_length = length - len(t)
    if remain_length <= 0:
        return t
    return (*t, *((fillvalue,) * remain_length))


def safe_get_tuple_index(tup, index, default=None):
    if len(tup) <= index:
        return default
    return tup[index]


def resolve_device(device=None):
    """The device to build on: None means the card ('cuda'). Raises when no
    GPU is present rather than falling back to the CPU; pass device='cpu'
    to build there."""
    import torch
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available: pass device="cpu" to build on the CPU')
    return device


def stage_progress(iterable, *, enabled, desc, total=None):
    """A per-stage progress bar over the cascade's stage loop, or the
    iterable itself when disabled or when tqdm is not installed."""
    if not enabled:
        return iterable
    try:
        from tqdm.auto import tqdm
    except ImportError:
        return iterable
    return tqdm(iterable, desc=desc, unit='stage', total=total, leave=False)
