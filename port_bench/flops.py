"""Operations of one U-Net forward per image row, counted on the reference.

    python -m port_bench.flops imagen-64-256

counts, on the meta device (no memory, no card), the floating-point
operations of one forward of each stage's reference U-Net for one image row
at the stage's size with a full text of `max_text_len` tokens, and prints
them with the parameter counts, the numbers each configuration file stores
as `flops_per_row` and `params`. Products count 2 per multiply-add
(`torch.utils.flop_counter`).

    python -m port_bench.flops --train imagen-64-256 1

counts one training row of a stage instead (the number a training mix
stores as `train_flops_per_row`): the loss's forward
(`reference.train.row_losses`) and its backward to every parameter.
"""
from __future__ import annotations

import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import registry
from port_bench.reference.unet import Unet
from port_bench.reference import train, unet_kwargs


def count(config):
    """([flops per row per stage], [params per stage]); 0 for a NullUnet stage."""
    flops, params = [], []
    for index, spec in enumerate(config['unets']):
        if spec['unet'] == 'NullUnet':
            flops.append(0)
            params.append(0)
            continue
        with torch.device('meta'):
            unet = Unet(**unet_kwargs(config, index))
            size = config['image_sizes'][index]
            x = torch.zeros(1, size, size, 3)
            kwargs = dict(text_embeds=torch.zeros(1, config['max_text_len'],
                                                  config['text_embed_dim']),
                          text_mask=torch.ones(1, config['max_text_len'], dtype=torch.bool),
                          drop_text=torch.zeros(1, dtype=torch.bool))
            if index > 0:
                kwargs.update(lowres_cond_img=torch.zeros(1, size, size, 3),
                              lowres_noise_times=torch.zeros(1))
            counter = FlopCounterMode(display=False)
            with counter, torch.no_grad():
                unet(x, torch.zeros(1), **kwargs)
        flops.append(int(counter.get_total_flops()))
        params.append(sum(p.numel() for p in unet.parameters()))
    return flops, params


def count_training(config, index):
    """Operations of one training row of stage `index` (a stage without a
    low-res condition), with a full text, on the meta device."""
    with torch.device('meta'):
        unet = Unet(**unet_kwargs(config, index))
        size, n = config['image_sizes'][index], config['max_text_len']
        inputs = dict(images=torch.zeros(1, size, size, 3),
                      text_embeds=torch.zeros(1, n, config['text_embed_dim']),
                      text_masks=torch.ones(1, n, dtype=torch.bool), t=torch.zeros(1),
                      eps=torch.zeros(1, size, size, 3), drop=torch.zeros(1, dtype=torch.bool))
        counter = FlopCounterMode(display=False)
        with counter:
            train.row_losses(unet, **inputs, min_snr_gamma=5.).sum().backward()
    return int(counter.get_total_flops())


def main(names):
    if names[:1] == ['--train']:
        name, number = names[1], int(names[2])
        print(f'{name} stage {number}: train_flops_per_row '
              f'{count_training(registry.config(name), number - 1)}')
        return
    for name in names:
        flops, params = count(registry.config(name))
        print(f'{name}: flops_per_row {flops}, params {params}')


if __name__ == '__main__':
    main(sys.argv[1:])
