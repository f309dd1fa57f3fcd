"""`unet.launches_per_fwd` (launches/fwd): kernels the device ran per U-Net forward.

Layer: U-Net (`imagen_tpu_torch/models/unet2d.py`, `models/blocks.py`).
Every kernel of the traced slice (the sampler's between forwards too; in a
training step the backward's, the optimiser's and the EMA's), over the U-Net
forwards in it, which forward hooks count. Moves `images_per_s`.
"""


def read(run):
    if run.trace is None or not run.slice_forwards or not run.trace.kernels():
        return None
    return run.trace.kernels() / run.slice_forwards
