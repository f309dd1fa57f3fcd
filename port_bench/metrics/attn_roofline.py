"""`attn_roofline` (%): the attention sites' share of their roofline.

Layer: kernels (`imagen_tpu_torch/ops/attention.py`,
`ops/flash_attention.py`, `csrc/flash_rows_fwd.cu`). Sites: every
`Attention` (multi-query self-attention, with context) and `CrossAttention`
module call in the traced slice. The bound counts the projections and both
attention products (`roofline.self_attention`, `roofline.cross_attention`);
the time is that of everything launched inside the sites. Moves
`images_per_s`.
"""
from port_bench import roofline

SITES = {'Attention': roofline.self_attention, 'CrossAttention': roofline.cross_attention}


def read(run):
    return roofline.site_roofline(run, 'attn_roofline')
