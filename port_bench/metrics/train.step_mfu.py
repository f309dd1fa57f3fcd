"""`train.step_mfu` (%): the whole training step's share of the chip's bf16 peak.

Layer: the whole step (`imagen_tpu_torch/trainer.py`
`ImagenTrainer.step_with_batch`). The rows trained in the window times the
mix's `train_flops_per_row` (one row's loss forward and its backward to
every parameter, counted on the reference by `port_bench/flops.py`), over
the window's seconds times 989 TFLOP/s. It still bounds a gain once a later
change takes a kernel off the path. Moves `images_per_s`.
"""
from port_bench import roofline


def read(run):
    flops = run.mix.get('train_flops_per_row')
    if not flops or not run.images or run.window_s <= 0:
        return None
    return 100. * run.images * flops / (run.window_s * roofline.PEAK_FLOPS)
