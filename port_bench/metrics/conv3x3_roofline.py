"""`conv3x3_roofline` (%): the 3x3 SAME convs' share of their roofline.

Layer: kernels (`imagen_tpu_torch/ops/conv2d.py`, `csrc/conv2d_same.cu`, or
cuDNN where the gate sends a site there). Sites: every `SameConv3x3` module
call in the traced slice, whatever computes it inside (the conv kernel,
cuDNN, the weight's cast and relayout). The metric is the sum of the sites'
least times (`roofline.conv3x3`) over the device time of everything launched
inside them. Moves `images_per_s`.
"""
from port_bench import roofline

SITES = {'SameConv3x3': roofline.conv3x3}


def read(run):
    return roofline.site_roofline(run, 'conv3x3_roofline')
