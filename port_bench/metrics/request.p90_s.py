"""`request.p90_s` (s): the 90th percentile of the window's request latencies.

Layer: request (`imagen_tpu_torch/serving.py` `ImagenServer.generate`, or
`diffusion/imagen.py` `Imagen.sample`). Each latency is the host clock from
sending a request to holding its images on the host, over every request of
the traced run's window. Moves `images_per_s`.
"""
import statistics


def read(run):
    if not run.latencies:
        return None
    if len(run.latencies) == 1:
        return run.latencies[0]
    return statistics.quantiles(run.latencies, n=10, method='inclusive')[8]
