"""The program's own recording, as the readers of its spans and counters see it.

`imagen_tpu_torch.utils.profiling` keeps the program's spans (`serve.generate`,
`sample`, `sample.step`, `unet.forward`) and its route counters (`conv3x3`,
`attention`) while a recording is on. A reader of them calls `begin(metric)`
when the harness loads it, which a `--trace 1` run does before set-up and a
`--trace 0` run never does; the first such call of a run turns a fresh
recording on, so it covers set-up, the window and the traced slice. Each
reader's `read` calls `take(metric)`, and the last of them turns the
recording off.

A request is a root span and every span under it. The span metrics take the
requests recorded with no profiler running: set-up's warm-up request, the
window's, and those that finish after the window, all of one shape. Where
the program keeps no recording (a checkout older than its recorder), `begin`
does nothing and the readers return None.
"""
from __future__ import annotations

import statistics

_holders = set()
_recording = None


def _profiling():
    try:
        from imagen_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, 'start_recording') else None


def begin(metric):
    """Called by `metric`'s reader when it is loaded: joins the run's
    recording, or turns a fresh one on where this reader was loaded before
    (a new run in the same process) or none is on."""
    global _recording
    profiling = _profiling()
    if profiling is None:
        return
    if _recording is None or metric in _holders:
        if profiling.active_recording() is not None:
            profiling.stop_recording()
        _holders.clear()
        _recording = profiling.start_recording()
    _holders.add(metric)


def take(metric):
    """The run's recording for `metric`'s reader (None where there is none);
    the last reader of the run to take it turns it off."""
    global _recording
    rec = _recording
    _holders.discard(metric)
    if not _holders and rec is not None:
        profiling = _profiling()
        if profiling.active_recording() is rec:
            profiling.stop_recording()
        _recording = None
    return rec


def median_over_requests(rec, per_request):
    """The median over the unprofiled requests of `per_request(spans)`, the
    requests where it gives None left out; None where none is left."""
    if rec is None:
        return None
    values = [per_request(spans) for spans in rec.requests(profiled=False).values()]
    values = [v for v in values if v is not None]
    return statistics.median(values) if values else None


def forward_ms(spans):
    """The mean host time of a request's `unet.forward` spans, in ms."""
    forwards = [s.ns for s in spans if s.name == 'unet.forward']
    return 1e-6 * sum(forwards) / len(forwards) if forwards else None


def step_self_ms(spans):
    """The mean over a request's `sample.step` spans of the step's host time
    less its child forwards', in ms."""
    steps = {s.id: s.ns for s in spans if s.name == 'sample.step'}
    if not steps:
        return None
    for s in spans:
        if s.name == 'unet.forward' and s.parent in steps:
            steps[s.parent] -= s.ns
    return 1e-6 * sum(steps.values()) / len(steps)
