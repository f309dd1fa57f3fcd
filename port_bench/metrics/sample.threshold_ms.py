"""`sample.threshold_ms` (ms): device time of dynamic thresholding a request.

Layer: sampler (`imagen_tpu_torch/diffusion/imagen.py`,
`Imagen.threshold_x_start`). The harness wraps the cascade instance's
method in a span; the metric is the device time launched inside those spans
over the traced slice, per request. Moves `images_per_s`.
"""
METHODS = ('threshold_x_start',)


def read(run):
    spent = run.trace.device_seconds_in('pb.call.sample.threshold_ms') if run.trace else {}
    if not spent or not run.slice_requests:
        return None
    return 1e3 * sum(spent.values()) / run.slice_requests
