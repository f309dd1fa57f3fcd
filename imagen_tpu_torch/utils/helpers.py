"""Pure-python helper utilities; counterpart of `imagen_tpu/utils/helpers.py`.

Config-time helpers only; tensor-touching helpers live in
`imagen_tpu_torch.ops.tensor_utils`.
"""


def exists(val):
    return val is not None


def default(val, d):
    if exists(val):
        return val
    return d() if callable(d) else d


def cast_tuple(val, length=None):
    if isinstance(val, list):
        val = tuple(val)

    output = val if isinstance(val, tuple) else ((val,) * default(length, 1))

    if exists(length) and len(output) != length:
        raise ValueError(
            f'tuple of length {len(output)} does not match expected length {length}')

    return output


def pad_tuple_to_length(t, length, fillvalue=None):
    remain_length = length - len(t)
    if remain_length <= 0:
        return t
    return (*t, *((fillvalue,) * remain_length))


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
