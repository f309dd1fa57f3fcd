"""The one traffic generator: requests made from a mix's parameters and a seed.

A mix (`port_bench/traffic/<name>.json`) gives `prompts` per request, each
prompt's token count drawn log-uniform over [`tokens_min`, `tokens_max`],
the text embeddings' scale `embed_std`, and optionally a start image of
`start_image_size` px. Request i of a run with seed s is the same on every
machine: its draws come from seeds derived from (s, i). Every request has
the same shapes (embeddings are cut at the longest prompt and the program
pads them), so every seed gives the same work in another order.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from port_bench.weights import derive


def token_counts(mix, seed, index):
    rng = np.random.default_rng(derive(seed, 'tokens', index))
    lo, hi = math.log(mix['tokens_min']), math.log(mix['tokens_max'])
    counts = np.exp(rng.uniform(lo, hi, size=mix['prompts']))
    return [int(min(mix['tokens_max'], max(mix['tokens_min'], round(c)))) for c in counts]


def request(mix, config, seed, index, device):
    """Request `index`: text embeddings (prompts, longest, dim) zero past each
    prompt's tokens, their mask, the seed of the sampler's generator and, for
    a mix with one, the start image (prompts, s, s, 3) in [0, 1]."""
    counts = token_counts(mix, seed, index)
    longest = max(counts)
    gen = torch.Generator(device=device).manual_seed(derive(seed, 'request', index))
    embeds = torch.randn((mix['prompts'], longest, config['text_embed_dim']), generator=gen,
                         device=device) * mix['embed_std']
    masks = (torch.arange(longest, device=device)[None]
             < torch.tensor(counts, device=device)[:, None])
    embeds = embeds * masks[..., None]
    out = dict(text_embeds=embeds, text_masks=masks, noise_seed=derive(seed, 'noise', index))
    if mix.get('start_image_size'):
        size = mix['start_image_size']
        out['start_image'] = torch.rand((mix['prompts'], size, size, 3), generator=gen,
                                        device=device)
    return out
