"""Seeded weights, made on the device in one draw per U-Net.

Both the program and the reference load the same tensors. One
`torch.randn` over every parameter of a U-Net fills a flat float32 buffer
from a generator on the device; each parameter is a view of it, scaled in
place by its kind: products at 1/sqrt(fan-in), norm gains and attention
scales at 1 + 0.1 n, biases at 0.02 n, and learned embeddings, null tokens
and latents at n. No parameter is left at zero.
"""
from __future__ import annotations

import hashlib
import math

import torch

UNIT = ('null_kv', 'null_text_embed', 'null_text_hidden', 'latents', 'pos_emb.weight',
        '.weights')
GAIN = ('.g', '.gamma', 'q_scale', 'k_scale')


def derive(seed, *tags):
    """A 63-bit seed from the run's seed and `tags`."""
    digest = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(digest[:8], 'little') >> 1


def scale_of(name, shape):
    """(multiplier, offset) that turns a standard normal draw into the parameter."""
    if name.endswith(UNIT):
        return 1., 0.
    if name.endswith(GAIN) or (name.endswith('weight') and len(shape) == 1):
        return 0.1, 1.
    if name.endswith('bias'):
        return 0.02, 0.
    if len(shape) >= 2:
        return 1. / math.sqrt(math.prod(shape[1:])), 0.
    raise ValueError(f'no rule for parameter {name} of shape {tuple(shape)}')


def make(specs, seed, device):
    """{name: tensor} for `specs` [(name, shape)], views of one flat buffer
    drawn from `seed` on `device`, laid out by name: the values do not
    depend on the order in which a module lists its parameters."""
    specs = sorted(specs)
    total = sum(math.prod(shape) for _, shape in specs)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in specs:
        n = math.prod(shape)
        view = flat[at:at + n].view(shape)
        mul, add = scale_of(name, shape)
        view.mul_(mul).add_(add)
        out[name] = view
        at += n
    return out

