"""`conv3x3.kernel_share` (%): the share of the 3x3 convs' work that the conv kernel does.

Layer: kernels (`imagen_tpu_torch/models/blocks.py` `SameConv3x3`, whose
gate `ops/conv2d.py` `conv2d_same_available` sends a call to the conv kernel
or to cuDNN). 100 x the operations (2 b H W 9 cin cout a call) that the
program's `conv3x3` counter saw routed `kernel`, over all of its operations,
counted over the whole traced run (`port_bench/recorder.py`). Every request
runs the same shapes, so the share does not depend on which part of the run
is counted. Moves `images_per_s`.
"""
from port_bench import recorder

NAME = 'conv3x3.kernel_share'
recorder.begin(NAME)


def read(run):
    rec = recorder.take(NAME)
    return rec.share('conv3x3', 'kernel') if rec is not None else None
