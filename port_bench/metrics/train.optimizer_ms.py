"""`train.optimizer_ms` (ms a step): device time of the optimiser's step.

Layer: optimizer (`imagen_tpu_torch/optim.py` `Adafactor.step`: the
factored second moments, the block-RMS clip, the parameter scale and the
bf16 momentum). The harness wraps the trainer's optimiser's `step` in a
span; the metric is the device time launched inside those spans over the
traced slice's steps. Moves `images_per_s`.
"""
METHODS = ('step',)
TARGET = 'optimizer'


def read(run):
    if run.trace is None or not run.slice_requests:
        return None
    spent = sum(run.trace.device_seconds_each('pb.call.train.optimizer_ms'))
    return 1e3 * spent / run.slice_requests if spent else None
