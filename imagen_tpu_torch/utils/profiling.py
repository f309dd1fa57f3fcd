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

The program's own spans and counters, and the recording that keeps them:

- `span(name)`: a context manager at a layer boundary of the program
  (`serve.generate`, `sample`, `sample.step`, `unet.forward`, and in the
  video U-Net `video.temporal` around each temporal PEG and attention pair
  and each pseudo-3D conv's temporal conv). With nothing
  recording and no torch profiler on, it returns one shared no-op object.
  Under a recording it keeps the span's host times; under a torch profiler
  (`trace`, or any `torch.profiler.profile`) it is also a
  `record_function` of the same name on the trace's timeline.
- `count(name, route, key, work)`: one gate decision, by the route it took
  and the shape `key`, with its work (operations); kept only under a
  recording. `conv3x3` (routes `kernel`, `cudnn`), `attention` (routes
  `flash`, `plain`), `temporal_attention` (the video U-Net's attention over
  the frames of each pixel, routes `kernel`, `plain`) and `threshold`
  (routes `kernel`, `kthvalue`; its work is elements) are counted where
  their routes are decided; `unet_graph` (routes `capture`, `replay`,
  `eager`; key the U-Net's class and input shape; work its rows) counts
  each U-Net forward by how it ran (`models/unet_graphs.py`).
- `taping()`: within the block nothing is recorded; the counters' calls and
  the kernel launches are kept on a `Tape`, whose `replay` counts the calls
  again and the launches into `ops._build.REPLAYED`, once for each run of
  what the block captured.
- `recording()` (or `start_recording()` ... `stop_recording()`): turns the
  recording on for the block and yields its `Recording`: the spans, the
  counters, the launches of the hand-written kernels
  (`ops._build.LAUNCHES`) made while it was on, and apart from them those
  that CUDA graph replays made (`ops._build.REPLAYED`).
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import Counter, defaultdict, deque
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

from imagen_tpu_torch.ops import _build


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


# --- the program's spans and counters ---------------------------------------------------

class Span(NamedTuple):
    """One closed span. `request` is the id of the outermost span open at
    its start (its own id for a root), `parent` that of the innermost (None
    for a root); times are `time.perf_counter_ns()`; `profiled` says whether
    a torch profiler was recording when it opened."""
    id: int
    parent: Optional[int]
    request: int
    name: str
    start_ns: int
    end_ns: int
    profiled: bool

    @property
    def ns(self):
        return self.end_ns - self.start_ns


class Recording:
    """What the program recorded while this recording was on.

    `spans` are the closed spans in the order they closed (a child before
    its parent); each thread nests its own. `counters` maps (name, route,
    key) to [calls, work].
    `launches` are the kernel launches made while it was on and `replayed`
    those that CUDA graph replays made (both frozen when it stops). `wall_ns` moves a span's host time onto the wall clock that the
    torch profiler stamps host events with: a Chrome trace event's `ts` x
    1000 + the trace's `baseTimeNanoseconds`."""

    def __init__(self):
        self.wall0_ns, self.clock0_ns = time.time_ns(), time.perf_counter_ns()
        self.spans = []
        self.counters = {}
        # thread -> its open spans, each [id, parent, request, name, start_ns, profiled]
        self._open = {}
        self._next = 0
        self._launches0 = Counter(_build.LAUNCHES)
        self._replayed0 = Counter(_build.REPLAYED)
        self._launches = self._replayed = None

    @property
    def launches(self):
        if self._launches is not None:
            return self._launches
        return Counter(_build.LAUNCHES) - self._launches0

    @property
    def replayed(self):
        if self._replayed is not None:
            return self._replayed
        return Counter(_build.REPLAYED) - self._replayed0

    def wall_ns(self, clock_ns):
        return self.wall0_ns + clock_ns - self.clock0_ns

    def _enter(self, name, profiled, start_ns):
        stack = self._open.setdefault(threading.get_ident(), [])
        sid = self._next
        self._next += 1
        entry = [sid, stack[-1][0] if stack else None, stack[0][0] if stack else sid, name,
                 start_ns, profiled]
        stack.append(entry)
        return entry

    def _exit(self, entry, end_ns):
        self._open[threading.get_ident()].remove(entry)
        sid, parent, request, name, start, profiled = entry
        self.spans.append(Span(sid, parent, request, name, start, end_ns, profiled))

    def requests(self, profiled=False):
        """{request id: [its spans, by start]} of the roots whose `profiled`
        flag is `profiled`."""
        roots = {s.id for s in self.spans if s.parent is None and s.profiled == profiled}
        out = defaultdict(list)
        for s in self.spans:
            if s.request in roots:
                out[s.request].append(s)
        for spans in out.values():
            spans.sort(key=lambda s: s.start_ns)
        return dict(out)

    def self_ns(self):
        """{span id: its duration less its children's}."""
        own = {s.id: s.ns for s in self.spans}
        for s in self.spans:
            if s.parent in own:
                own[s.parent] -= s.ns
        return own

    def routes(self, name):
        """{route: [calls, work]} of counter `name`."""
        out = defaultdict(lambda: [0, 0])
        for (n, route, _), (calls, work) in self.counters.items():
            if n == name:
                out[route][0] += calls
                out[route][1] += work
        return dict(out)

    def share(self, name, route):
        """100 x the work of counter `name` that took `route`, over all of
        its work; None where it counted no work."""
        routes = self.routes(name)
        total = sum(work for _, work in routes.values())
        return 100. * routes.get(route, (0, 0))[1] / total if total else None


class _NoSpan:
    """The span of a program that nothing records."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
_recording: Optional[Recording] = None
_tape: Optional['Tape'] = None


class _Span:
    __slots__ = ('name', 'fn', 'recording', 'entry')

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        profiled = _autograd_profiler._is_profiler_enabled
        self.recording = rec = _recording
        if rec is not None:
            self.entry = rec._enter(self.name, profiled, time.perf_counter_ns())
        self.fn = None
        if profiled:
            self.fn = torch.profiler.record_function(self.name)
            self.fn.__enter__()
        return self

    def __exit__(self, *exc):
        if self.fn is not None:
            self.fn.__exit__(*exc)
        if self.recording is not None:
            self.recording._exit(self.entry, time.perf_counter_ns())
        return False


def span(name: str):
    """A span of the program's layer `name`, as a context manager."""
    if _recording is None and not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name)


def count(name: str, route: str, key: tuple, work: int):
    """Count one call of gate `name` that took `route` at shape `key`, with
    `work` operations; nothing unless a recording is on (on the tape
    instead inside `taping`)."""
    if _tape is not None:
        _tape.counts.append((name, route, key, work))
        return
    rec = _recording
    if rec is None:
        return
    kept = rec.counters.get((name, route, key))
    if kept is None:
        rec.counters[(name, route, key)] = [1, work]
    else:
        kept[0] += 1
        kept[1] += work


def start_recording() -> Recording:
    """Turn the recording on; returns it. One recording at a time."""
    global _recording
    if _recording is not None:
        raise RuntimeError('a recording is already on')
    _recording = Recording()
    return _recording


def stop_recording() -> Recording:
    """Turn the recording off; returns what it kept."""
    global _recording
    rec, _recording = _recording, None
    if rec is None:
        raise RuntimeError('no recording is on')
    rec._launches, rec._replayed = rec.launches, rec.replayed
    return rec


def active_recording() -> Optional[Recording]:
    """The recording that is on, or None."""
    return _recording


class Tape:
    """What a block counted and launched while `taping`: `counts` the
    `count` calls in order, `launches` the kernel launches by name."""

    def __init__(self):
        self.counts = []
        self.launches = Counter()

    def replay(self):
        """Count it all again: the counters into the recording that is on,
        the launches into `ops._build.REPLAYED`."""
        for entry in self.counts:
            count(*entry)
        _build.REPLAYED.update(self.launches)


@contextlib.contextmanager
def taping():
    """Keep the block's counters and launches on the `Tape` it yields, out of
    the recording and out of `ops._build.LAUNCHES` (a launch under capture
    runs nothing); its spans are not recorded. For a block that captures
    work a replay runs later: each replay then counts it with
    `Tape.replay`."""
    global _recording, _tape
    if _tape is not None:
        raise RuntimeError('a tape is already on')
    tape, kept = Tape(), _recording
    before = Counter(_build.LAUNCHES)
    _recording, _tape = None, tape
    try:
        yield tape
    finally:
        _recording, _tape = kept, None
        tape.launches = Counter(_build.LAUNCHES) - before
        _build.LAUNCHES.clear()
        _build.LAUNCHES.update(before)


@contextlib.contextmanager
def recording():
    """Record the block; yields the `Recording`."""
    rec = start_recording()
    try:
        yield rec
    finally:
        stop_recording()
