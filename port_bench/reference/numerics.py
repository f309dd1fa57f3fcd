"""The arithmetic every product of the reference goes through.

The reference computes in float32 with TF32 off. The control, which stands
in for a program that computes below the precision its configuration states,
runs the same code with every operand of every product (linear, conv and
both attention products) rounded to float8 e4m3 on a per-tensor scale, and
accumulates in float32: `with precision('fp8'): ...`.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

_PRECISION = contextvars.ContextVar('precision', default='fp32')
FP8_MAX = 448.   # the largest finite float8 e4m3fn value


@contextlib.contextmanager
def precision(name):
    """Products inside the block round their operands to `name` ('fp32' or 'fp8')."""
    if name not in ('fp32', 'fp8'):
        raise ValueError(f'unknown precision {name!r}')
    token = _PRECISION.set(name)
    try:
        yield
    finally:
        _PRECISION.reset(token)


def no_tf32():
    """Float32 products in float32 on the card, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rounded(t):
    """`t` as the current precision holds it, back in float32."""
    t = t.float()
    if _PRECISION.get() == 'fp32':
        return t
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x, w, b=None):
    return F.linear(rounded(x), rounded(w), None if b is None else b.float())


def conv2d(x, w, b=None, stride=1, padding=0):
    """NCHW conv."""
    return F.conv2d(rounded(x), rounded(w), None if b is None else b.float(), stride, padding)


def einsum(spec, a, b):
    return torch.einsum(spec, rounded(a), rounded(b))
