"""The plain reference: float32 PyTorch, TF32 off, nothing of the program.

`build(config, weights_of, device)` makes each stage's U-Net of a
configuration (None for a `NullUnet` stage) and loads its weights;
`ddpm.sample` runs the cascade.
"""
from __future__ import annotations

import torch

from port_bench.reference import ddpm  # noqa: F401  (the sampler, for callers)
from port_bench.reference.unet import Unet


def unet_kwargs(config, index):
    spec = {k: v for k, v in config['unets'][index].items() if k != 'unet'}
    return dict(spec, text_embed_dim=config['text_embed_dim'],
                max_text_len=config['max_text_len'], lowres_cond=index > 0)


def specs(config, index):
    """[(name, shape)] of stage `index`'s parameters, from the reference."""
    with torch.device('meta'):
        unet = Unet(**unet_kwargs(config, index))
    return [(name, tuple(t.shape)) for name, t in unet.state_dict().items()]


def build(config, weights_of, device):
    """The stages' U-Nets on `device`, each holding `weights_of(index, specs)`,
    the tensors for its (name, shape) list."""
    unets = []
    for index, spec in enumerate(config['unets']):
        if spec['unet'] == 'NullUnet':
            unets.append(None)
            continue
        with torch.device('meta'):
            unet = Unet(**unet_kwargs(config, index))
        specs = [(name, tuple(t.shape)) for name, t in unet.state_dict().items()]
        unet.load_state_dict(weights_of(index, specs), strict=True, assign=True)
        unets.append(unet.to(device).eval())
    return unets
