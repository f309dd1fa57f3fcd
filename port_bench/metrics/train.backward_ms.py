"""`train.backward_ms` (ms a step): device time of the training step's backward pass.

Layer: backward (`imagen_tpu_torch/trainer.py` `ImagenTrainer._backward`:
the loss's forward and `backward()`, which runs the flash backward, the
autograd paths of the conv and feedforward kernels and every other
gradient). The harness wraps the trainer's `_backward` in a span; the metric
is the device time launched inside those spans less that launched inside
the U-Net forward spans nested in them, over the traced slice's steps.
Moves `images_per_s`.
"""
METHODS = ('_backward',)
TARGET = 'trainer'


def read(run):
    if run.trace is None or not run.slice_requests:
        return None
    spent = sum(run.trace.device_seconds_each('pb.call.train.backward_ms'))
    if not spent:
        return None
    stage = run.mix.get('unet_number', 1) - 1
    forward = sum(run.trace.device_seconds_each(f'pb.unet{stage}'))
    return 1e3 * (spent - forward) / run.slice_requests
