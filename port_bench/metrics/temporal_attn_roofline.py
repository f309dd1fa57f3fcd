"""`temporal_attn_roofline` (%): the temporal attention sites' share of their roofline.

Layer: kernels (`imagen_tpu_torch/models/video_blocks.py`
`TemporalAttention`, `ops/flash_attention.py` `flash_grouped_cosine`,
`csrc/temporal_attn_fwd.cu`, kernel 4). Sites: every `TemporalAttention`
module call in the traced slice: the LayerNorm, the fold of (b, f, h, w, c)
to each pixel's frames, the q, kv and out projections, the relative
position bias MLP, both products over f x (f + 1) keys in kernel 4, the
out-norm, the unfold and the residual. The bound (`least_work`) counts the
projections', the products' and the bias MLP's operations, and the input,
the output and the parameters read once; the time is that of everything
launched inside the sites. Moves `images_per_s`.
"""
from torch import nn

from port_bench import roofline


def _bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def least_work(module, args, kwargs, output):
    """(operations, bytes) of one `TemporalAttention` call on x (b, f, h, w, c)."""
    x = args[0]
    attn = module.fn.fn
    b, f, hh, ww, c = x.shape
    pixels, heads, dh = b * hh * ww, attn.heads, attn.dim_head
    inner = heads * dh
    flops = (2 * pixels * f * c * (inner + 2 * dh)         # q and kv projections
             + 4 * pixels * heads * f * (f + 1) * dh         # QK^T and PV
             + 2 * pixels * f * inner * c)                   # out projection
    flops += 2 * (2 * f - 1) * sum(m.in_features * m.out_features
                                   for m in attn.rel_pos_bias.modules()
                                   if isinstance(m, nn.Linear))
    return flops, _bytes(x, output, *module.parameters())


SITES = {'TemporalAttention': least_work}


def read(run):
    return roofline.site_roofline(run, 'temporal_attn_roofline')
