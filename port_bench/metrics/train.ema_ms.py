"""`train.ema_ms` (ms an update): device time of one EMA update.

Layer: EMA (`imagen_tpu_torch/ema.py` `ema_update`, which the trainer calls
after every optimiser step and which updates on every `update_every`-th).
The harness wraps the trainer module's `ema_update` in a span; the metric
is the device time launched inside the spans in which the device ran
anything, over their number. A traced slice of `update_every` steps holds
one update. Moves `images_per_s`.
"""
METHODS = ('ema_update',)
TARGET = 'trainer_module'


def read(run):
    if run.trace is None:
        return None
    updates = [s for s in run.trace.device_seconds_each('pb.call.train.ema_ms') if s]
    return 1e3 * sum(updates) / len(updates) if updates else None
