"""`sample.step_self_ms` (ms): the sampler's own host time a step.

Layer: sampler (`imagen_tpu_torch/diffusion/imagen.py` `Imagen.p_sample`,
`diffusion/elucidated.py`'s step at each sigma): guidance's doubling and
recombination, x0, thresholding's launches, the posterior and the step
noise. For each request recorded with no profiler running
(`port_bench/recorder.py`), the mean over its `sample.step` spans of the
step's host time less that of its child `unet.forward` spans; the metric is
the median over those requests. Set-up's warm-up request and those that
finish after the window enter the median, a small minority of the same
shape. Moves `images_per_s`.
"""
from port_bench import recorder

NAME = 'sample.step_self_ms'
recorder.begin(NAME)


def read(run):
    return recorder.median_over_requests(recorder.take(NAME), recorder.step_self_ms)
