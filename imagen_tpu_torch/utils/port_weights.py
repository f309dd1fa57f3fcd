"""Weights bridge: JAX package params -> this package's `state_dict`.

The port's modules keep lucidrains' `state_dict` key names and torch shapes,
so this is the inverse of the JAX side's tables (reference `state_dict` ->
flax params): the same path tables (`utils/_ref_keys.py`, the port's own
copy), with each layout conversion undone. Numpy only; no JAX import.

    sd = state_dict_from_jax(jax_variables['params'])
    unet.load_state_dict(sd, strict=True)

Video (`Unet3D`) params are recognised by their temporal modules, or named
with `video=True`. lucidrains' video `Conv2d` is an `nn.Conv3d` with a unit
time kernel, so most video convs carry 5-D weights:

- PseudoConv3d spatial conv (kh, kw, I, O) -> (O, I, kh, kw); temporal conv
  (k, I, O) -> Conv1d (O, I, k);
- every other k x k conv (kh, kw, I, O) -> (O, I, 1, kh, kw);
- 1x1 convs held as Dense kernels (I, O) -> (O, I, 1, 1, 1);
- the temporal PEG's depthwise kernel (3, 1, C) -> (C, 1, 3, 1, 1);
- the temporal resamplers' Dense (I, O) -> Conv1d (O, I, 1);
- the video feedforward's ChanLayerNorm gains (C,) -> (1, C, 1, 1, 1).

A linear-attention block (LinearAttention + ChanFeedForward, found by its
`to_q_proj` leaf) holds lucidrains' channel shapes: its Dense kernels are
1x1 conv weights (O, I, 1, 1), (O, I, 1, 1, 1) for video, except the
context projection's, which stays a Linear; its gains are ChanLayerNorm's
(1, C, 1, 1), (1, C, 1, 1, 1) for video; the depthwise 3x3 kernel
(3, 3, 1, C) becomes (C, 1, 3, 3), (C, 1, 1, 3, 3) for video.

lucidrains allocates `null_attn_bias` on every video attention; the JAX
package, and so the port, holds it only where a relative position bias uses
it (the temporal attentions, not `mid_attn`), so it is neither produced
here nor expected by `load_state_dict(strict=True)`.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from imagen_tpu_torch.utils._ref_keys import ref_key_for, ref_key_for_video

# 2D: reference 1x1 Conv2d weights (O, I, 1, 1) where flax holds a Dense kernel (I, O)
_CONV1X1 = re.compile(
    r'(res_conv|gca\.to_k|gca\.net\.[02]|downs\.\d+\.[04]\.1|downs\.\d+\.4\.fns\.1)\.weight$')
# ChanRMSNorm gains, (C, 1, 1) in the reference
_CHAN_GAMMA = re.compile(r'(^|\.)norm\.gamma$')

# video: Dense kernels that are 1x1x1 Conv3d weights (O, I, 1, 1, 1)
_VIDEO_CONV1X1X1 = re.compile(
    r'(res_conv|gca\.to_k|gca\.net\.[02]|downs\.\d+\.[07]\.1|downs\.\d+\.7\.fns\.1'
    r'|ups\.\d+\.6\.net\.0|(downs\.\d+\.3|ups\.\d+\.2)\.layers\.\d+\.1\.[15])\.weight$')
# video: Dense kernels that are Conv1d weights (O, I, 1)
_VIDEO_CONV1D = re.compile(r'(downs\.\d+\.6|ups\.\d+\.5)\.conv\.weight$')
# video: ChanLayerNorm gains of the feedforward, (1, C, 1, 1, 1)
_VIDEO_CHAN_LN = re.compile(r'(downs\.\d+\.3|ups\.\d+\.2)\.layers\.\d+\.1\.[04]\.g$')
_VIDEO_PATH = re.compile(r'(^|/)(\w+_temporal_(peg|attn|down|up)|spatial_conv)(/|$)')
# the JAX path of a linear-attention block, from one of its LinearAttention leaves
_LINEAR_BLOCK = re.compile(r'^(.*/)attn_\d+/to_q_proj/kernel$')


def _chan_kernel(ref_key, chan):
    """Whether a Dense kernel of a linear-attention block is a 1x1 conv's
    (all but the context projection's)."""
    return chan and not ref_key.endswith('to_context.1.weight')


def _flatten(tree, prefix=()):
    for name, value in tree.items():
        if isinstance(value, dict) or hasattr(value, 'items'):
            yield from _flatten(value, prefix + (name,))
        else:
            yield '/'.join(prefix + (name,)), value


def _to_torch_layout(a, ref_key, leaf, chan=False):
    if leaf == 'kernel':
        if a.ndim == 2:
            a = a.T
            conv = _CONV1X1.search(ref_key) or _chan_kernel(ref_key, chan)
            return a[:, :, None, None] if conv else a
        if a.ndim == 4:
            return a.transpose(3, 2, 0, 1)  # (kh, kw, I, O) -> (O, I, kh, kw)
        raise ValueError(f'kernel of rank {a.ndim} at {ref_key}')
    if _CHAN_GAMMA.search(ref_key):
        return a.reshape(-1, 1, 1)
    if chan and leaf == 'g':
        return a.reshape(1, -1, 1, 1)
    return a


def _to_torch_layout_video(a, ref_key, path, chan=False):
    if path.endswith('/kernel'):
        if a.ndim == 2:
            a = a.T
            if _VIDEO_CONV1X1X1.search(ref_key) or _chan_kernel(ref_key, chan):
                return a[:, :, None, None, None]
            return a[:, :, None] if _VIDEO_CONV1D.search(ref_key) else a
        if a.ndim == 3:
            if 'temporal_peg/' in path:  # depthwise (3, 1, C) -> (C, 1, 3, 1, 1)
                return a[:, 0, :].T.reshape(a.shape[2], 1, a.shape[0], 1, 1)
            return a.transpose(2, 1, 0)  # temporal conv (k, I, O) -> (O, I, k)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
            return a if ref_key.endswith('spatial_conv.weight') else a[:, :, None]
        raise ValueError(f'kernel of rank {a.ndim} at {ref_key}')
    if _CHAN_GAMMA.search(ref_key):
        return a.reshape(-1, 1, 1)
    if _VIDEO_CHAN_LN.search(ref_key) or (chan and path.endswith('/g')):
        return a.reshape(1, -1, 1, 1, 1)
    return a


def state_dict_from_jax(flax_params, video=None):
    """Map the JAX package's params (a nested dict of arrays, with or without
    the top 'params' key) to the port's `state_dict`. `video` selects the
    `Unet3D` table; None tells it from the paths. Every JAX leaf is consumed
    exactly once; `load_state_dict(strict=True)` then checks that every port
    parameter was given."""
    if set(flax_params.keys()) == {'params'}:
        flax_params = flax_params['params']
    leaves = list(_flatten(flax_params))
    if video is None:
        video = any(_VIDEO_PATH.search(path) for path, _ in leaves)
    linear_blocks = tuple({m.group(1) for path, _ in leaves
                           if (m := _LINEAR_BLOCK.match(path))})
    out = {}
    for path, leaf in leaves:
        key = ref_key_for_video(path) if video else ref_key_for(path)
        if key in out:
            raise KeyError(f'two JAX leaves map to {key!r} (second: {path!r})')
        a = np.asarray(leaf, dtype=np.float32)
        chan = path.startswith(linear_blocks)
        if video:
            a = _to_torch_layout_video(a, key, path, chan)
        else:
            a = _to_torch_layout(a, key, path.rsplit('/', 1)[-1], chan)
        out[key] = torch.from_numpy(np.array(a, dtype=np.float32, order='C'))
    return out
