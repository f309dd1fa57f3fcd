"""Frozen T5 text encoder; counterpart of `imagen_tpu/models/t5.py`.

transformers' torch `T5EncoderModel`, run under `torch.no_grad()`, with the
same max length of 256, padding positions zeroed and the default
`google/t5-v1_1-base`. `transformers` is imported only when text is
encoded. Models and tokenizers are cached per name in `T5_CONFIGS[name]`
under the JAX keys ('model', 'tokenizer', 'config'), so a caller may put its
own there.

A cached model is never moved. One loaded here is put on the device of the
call that loads it (None: the card) and stays there; one a caller puts in
the cache stays where the caller put it. Every call runs the model where it
is and moves the encodings to the device the caller asked for, so callers
on different devices (the imagen on the card, a data loader's collator on
the CPU) share one copy.
"""
from __future__ import annotations

from typing import List

import torch

from imagen_tpu_torch.utils.helpers import default, exists, resolve_device

MAX_LENGTH = 256

DEFAULT_T5_NAME = 'google/t5-v1_1-base'

# d_model of common checkpoints, so configs build without a download
T5_ENCODED_DIMS = {
    'google/t5-v1_1-small': 512,
    'google/t5-v1_1-base': 768,
    'google/t5-v1_1-large': 1024,
    'google/t5-v1_1-xl': 2048,
    'google/t5-v1_1-xxl': 4096,
    't5-small': 512,
    't5-base': 768,
    't5-large': 1024,
    't5-3b': 1024,
    't5-11b': 1024,
}

T5_CONFIGS = {}


def get_model_and_tokenizer(name, device=None):
    """The cached (model, tokenizer) of `name`; a model loaded here goes on
    `device` (None: the card)."""
    entry = T5_CONFIGS.setdefault(name, {})
    if 'model' not in entry:
        from transformers import T5EncoderModel
        model = T5EncoderModel.from_pretrained(name).eval()
        entry['model'] = model.to(resolve_device(device))
    if 'tokenizer' not in entry:
        from transformers import T5Tokenizer
        entry['tokenizer'] = T5Tokenizer.from_pretrained(name, model_max_length=MAX_LENGTH)
    return entry['model'], entry['tokenizer']


def model_device(model):
    return next(model.parameters()).device


def get_encoded_dim(name):
    if name in T5_ENCODED_DIMS:
        return T5_ENCODED_DIMS[name]
    entry = T5_CONFIGS.setdefault(name, {})
    if 'config' not in entry:
        if 'model' in entry:
            entry['config'] = entry['model'].config
        else:
            from transformers import T5Config
            entry['config'] = T5Config.from_pretrained(name)
    return entry['config'].d_model


def t5_tokenize(texts: List[str], name=DEFAULT_T5_NAME, device=None):
    """(token ids, attention mask), both (b, n) int64, padded to the longest,
    on `device` (None: the model's)."""
    model, tokenizer = get_model_and_tokenizer(name, device)
    encoded = tokenizer.batch_encode_plus(texts, return_tensors='pt', padding='longest',
                                          max_length=MAX_LENGTH, truncation=True)
    device = default(device, lambda: model_device(model))
    return encoded.input_ids.to(device), encoded.attention_mask.to(device)


@torch.no_grad()
def t5_encode_tokenized_text(token_ids, attn_mask=None, pad_id=None, name=DEFAULT_T5_NAME):
    """(b, n, d) fp32 encodings of `token_ids`, on their device, zero at the
    padding positions (`attn_mask` False, or the tokens equal to `pad_id`)."""
    if not (exists(attn_mask) or exists(pad_id)):
        raise ValueError('pass attn_mask or pad_id')
    model, _ = get_model_and_tokenizer(name, token_ids.device)
    attn_mask = default(attn_mask, lambda: (token_ids != pad_id).long())
    here = model_device(model)
    out = model(input_ids=token_ids.to(here),
                attention_mask=attn_mask.to(here)).last_hidden_state.float()
    out = out.to(token_ids.device)
    return out.masked_fill(~attn_mask.bool()[..., None], 0.)


def t5_encode_text(texts: List[str], name=DEFAULT_T5_NAME, return_attn_mask=False,
                   device=None):
    """Encode `texts` onto `device` (None: the card): (b, n, d) fp32, and the
    (b, n) bool mask with `return_attn_mask`."""
    device = resolve_device(device)
    get_model_and_tokenizer(name, device)   # loads onto `device` unless cached
    token_ids, attn_mask = t5_tokenize(texts, name=name)   # on the model's device
    encoded = t5_encode_tokenized_text(token_ids, attn_mask=attn_mask, name=name).to(device)
    if return_attn_mask:
        return encoded, attn_mask.to(device).bool()
    return encoded
