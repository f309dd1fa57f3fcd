"""`video.temporal_ms` (ms a request): device time of the video U-Net's temporal layers.

Layer: video temporal (`imagen_tpu_torch/models/video_blocks.py`:
`TemporalPeg`, `TemporalAttention` with its relayouts and kernel 4
`csrc/temporal_attn_fwd.cu`, and `PseudoConv3d`'s `CausalTemporalConv`;
`models/unet3d.py`). The program opens a `video.temporal` span around each
temporal PEG and attention pair and around each pseudo-3D conv's temporal
conv; the harness opens a site span around each of those modules' calls, so
the sites hold exactly the work of the program's spans. The metric is the
device time launched inside the sites over the traced slice's requests; None
where the program records no `video.temporal` span
(`port_bench/recorder.py`). Moves `images_per_s`.
"""
from port_bench import recorder

NAME = 'video.temporal_ms'
SITES = {name: (lambda module, args, kwargs, output: (0, 0))
         for name in ('TemporalPeg', 'TemporalAttention', 'CausalTemporalConv')}
recorder.begin(NAME)


def read(run):
    rec = recorder.take(NAME)
    if rec is None or not any(s.name == 'video.temporal' for s in rec.spans):
        return None
    spent = run.trace.device_seconds_in(f'pb.site.{NAME}') if run.trace else {}
    if not spent or not run.slice_requests:
        return None
    return 1e3 * sum(spent.values()) / run.slice_requests
