"""`step_mfu` (%): the whole step's share of the chip's bf16 peak.

Layer: the whole step. The operations of every U-Net forward completed in
the window (rows x the configuration's `flops_per_row` of its stage, counted
on the reference by `port_bench/flops.py`; forward hooks count the rows),
over the window's seconds times 989 TFLOP/s. It still bounds a gain once a
later change takes a kernel off the path. Moves `images_per_s`.
"""
from port_bench import roofline


def read(run):
    if not run.forward_rows or run.window_s <= 0:
        return None
    flops = sum(rows * run.config['flops_per_row'][stage] for stage, rows in run.forward_rows)
    return 100. * flops / (run.window_s * roofline.PEAK_FLOPS)
