"""Tracing and timing helpers; counterpart of `imagen_tpu/utils/profiling.py`.

- `trace(logdir)`: a `torch.profiler` trace (CPU and, where there is one, CUDA
  activity) of the block, written into `logdir` as a Chrome trace that
  TensorBoard's profiler plugin and Perfetto open.
- `annotate(name)`: a named span on the trace's timeline.
- `block_on(tree)`: waits for the devices of every tensor in a nested
  structure, for honest timing.
- `StepTimer`: wall time per step over a rolling window. `stop` synchronises
  the CUDA device first when given one, so a step's time is the time its
  device work took to finish, not the time it took to enqueue.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the block into `logdir`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir))):
        yield


def annotate(name: str):
    """A named span of the profiler's timeline, as a context manager."""
    return torch.profiler.record_function(name)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def block_on(tree):
    """Wait until every CUDA device that holds a tensor of `tree` (nested
    dicts, lists and tuples) has finished its queued work; returns `tree`."""
    for device in {t.device for t in _leaves(tree) if t.device.type == 'cuda'}:
        torch.cuda.synchronize(device)
    return tree


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

    @contextlib.contextmanager
    def measure(self, device=None):
        """Time the block as one step, synchronising `device` at its end."""
        self.start()
        yield
        self.stop(device)

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
