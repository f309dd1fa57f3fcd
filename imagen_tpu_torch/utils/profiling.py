"""Rolling step-time statistics; counterpart of `StepTimer` in
`imagen_tpu/utils/profiling.py`.

`stop` synchronises the CUDA device first when given one, so a step's time is
the time its device work took to finish, not the time it took to enqueue.
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch


class StepTimer:
    """Wall time per step over the last `window` steps."""

    def __init__(self, window: int = 100):
        self.times = deque(maxlen=window)
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, device=None):
        if device is not None and torch.device(device).type == 'cuda':
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    def summary(self):
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return dict(
            mean_s=float(arr.mean()),
            p50_s=float(np.percentile(arr, 50)),
            p90_s=float(np.percentile(arr, 90)),
            steps_per_sec=float(1.0 / arr.mean()),
            n=len(arr),
        )
