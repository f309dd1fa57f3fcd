"""`unet.host_ms_per_fwd` (ms): the host's time per U-Net forward.

Layer: U-Net (`imagen_tpu_torch/models/unet2d.py` `Unet.forward`,
`models/unet3d.py` `Unet3D.forward`). For each request recorded with no
profiler running (`port_bench/recorder.py`), the summed host time of its
`unet.forward` spans over their number; the metric is the median over
those requests. Besides the window's requests, set-up's warm-up request and
those that finish after the window enter the median, a small minority of
the same shape. A training step opens no request span, so there each
forward is a request of its own. Where the host waits on a full launch
queue this reads close to the device's time a forward. Moves `images_per_s`.
"""
from port_bench import recorder

NAME = 'unet.host_ms_per_fwd'
recorder.begin(NAME)


def read(run):
    return recorder.median_over_requests(recorder.take(NAME), recorder.forward_ms)
