"""The arithmetic every product of the reference goes through.

The reference computes in float32 with TF32 off. The control, which stands
in for a program that computes below the precision its configuration states,
runs the same code with every operand of every product (linear, conv and
both attention products) rounded to float8 e4m3 on a per-tensor scale, and
accumulates in float32: `with precision('fp8'): ...`. In a training step the
gradients that reach those operands are rounded the same way. `precision('bf16')`
rounds them to bfloat16 instead, the precision the configurations state: a
witness of what that rounding alone does to a reading.
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
    """Products inside the block round their operands to `name` ('fp32',
    'bf16' or 'fp8')."""
    if name not in ('fp32', 'bf16', 'fp8'):
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


def _fp8(t):
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _bf16(t):
    return t.to(torch.bfloat16).float()


ROUNDING = {'fp8': _fp8, 'bf16': _bf16}


class _Rounded(torch.autograd.Function):
    """Rounds as `how` names, and so the gradient on its way back."""

    @staticmethod
    def forward(ctx, t, how):
        ctx.how = how
        return ROUNDING[how](t)

    @staticmethod
    def backward(ctx, grad):
        return ROUNDING[ctx.how](grad), None


def rounded(t):
    """`t` as the current precision holds it, back in float32. Under
    autograd, the gradient that reaches a product's operand is rounded too."""
    t = t.float()
    how = _PRECISION.get()
    if how == 'fp32':
        return t
    return _Rounded.apply(t, how) if t.requires_grad else ROUNDING[how](t)


def linear(x, w, b=None):
    return F.linear(rounded(x), rounded(w), None if b is None else b.float())


def conv2d(x, w, b=None, stride=1, padding=0):
    """NCHW conv."""
    return F.conv2d(rounded(x), rounded(w), None if b is None else b.float(), stride, padding)


def einsum(spec, a, b):
    return torch.einsum(spec, rounded(a), rounded(b))
