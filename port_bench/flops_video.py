"""Operations of one video U-Net forward per clip row, counted on the reference.

    python -m port_bench.flops_video unet3d-64-f16

counts, on the meta device (no memory, no card), the floating-point
operations of one forward of the configuration's reference `Unet3D` for one
clip row of `frames` frames at its size with a full text of `max_text_len`
tokens, and prints them with the parameter count: the numbers the
configuration file stores as `flops_per_row` and `params`. Products count 2
per multiply-add (`torch.utils.flop_counter`).
"""
from __future__ import annotations

import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import registry
from port_bench.reference.unet3d import Unet3D, unet_kwargs


def count(config):
    """(flops of one clip row, params) of the configuration's one stage."""
    size, n = config['image_sizes'][0], config['max_text_len']
    with torch.device('meta'):
        unet = Unet3D(**unet_kwargs(config))
        x = torch.zeros(1, config['frames'], size, size, 3)
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            unet(x, torch.zeros(1), text_embeds=torch.zeros(1, n, config['text_embed_dim']),
                 text_mask=torch.ones(1, n, dtype=torch.bool),
                 drop_text=torch.zeros(1, dtype=torch.bool))
    return int(counter.get_total_flops()), sum(p.numel() for p in unet.parameters())


def main(names):
    for name in names:
        flops, params = count(registry.config(name))
        print(f'{name}: flops_per_row [{flops}], params [{params}]')


if __name__ == '__main__':
    main(sys.argv[1:])
