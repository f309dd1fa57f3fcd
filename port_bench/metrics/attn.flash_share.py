"""`attn.flash_share` (%): the share of attention's work that the flash kernel does.

Layer: kernels (`imagen_tpu_torch/ops/attention.py`: the gate
`ops/flash_attention.py` `flash_attention_available` of
`multiquery_attention_packed` and `multiquery_attention`;
`multihead_attention`, which cross-attention and the Perceiver pool call,
is always plain). 100 x the operations of QK^T and PV (4 b h i j d a call)
that the program's `attention` counter saw routed `flash`, over all of its
operations, counted over the whole traced run (`port_bench/recorder.py`).
Moves `images_per_s`.
"""
from port_bench import recorder

NAME = 'attn.flash_share'
recorder.begin(NAME)


def read(run):
    rec = recorder.take(NAME)
    return rec.share('attention', 'flash') if rec is not None else None
