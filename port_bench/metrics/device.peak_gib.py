"""`device.peak_gib` (GiB): the allocator's peak over the window.

Layer: device. `torch.cuda.max_memory_allocated` after the window, the
statistics reset when set-up ended. Moves `images_per_s`.
"""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
