"""`temporal_attn.kernel_share` (%): the share of temporal attention's work that kernel 4 does.

Layer: kernels (`imagen_tpu_torch/models/video_blocks.py` `VideoAttention`,
whose gate `ops/flash_attention.py` `grouped_temporal_available` sends the
attention over each pixel's frames to the temporal kernel,
`csrc/temporal_attn_fwd.cu`, or to the plain einsum). 100 x the operations
of QK^T and PV (4 pixels x heads x frames x (frames + 1) x d a call) that the
program's `temporal_attention` counter saw routed `kernel`, over all of its
operations, counted over the whole traced run (`port_bench/recorder.py`).
Moves `images_per_s`.
"""
from port_bench import recorder

NAME = 'temporal_attn.kernel_share'
recorder.begin(NAME)


def read(run):
    rec = recorder.take(NAME)
    return rec.share('temporal_attention', 'kernel') if rec is not None else None
