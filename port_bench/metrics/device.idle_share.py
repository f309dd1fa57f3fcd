"""`device.idle_share` (%): the share of a request in which the device runs nothing.

Layer: device. 100 x (1 - the device's busy seconds a request, the union of
the device operations' intervals in the traced slice over its requests,
over the median latency of the window's unprofiled requests). The profiler
records every host-side operation, which stretches a host-paced request
(about 2x for the 64->256 cascade), so the slice's own wall time would
overstate the idle share; the device's busy time is not stretched. Moves
`images_per_s`.
"""
import statistics


def read(run):
    if run.trace is None or not run.trace.ops or not run.slice_requests or not run.latencies:
        return None
    busy = run.trace.busy_s() / run.slice_requests
    return 100. * (1. - busy / statistics.median(run.latencies))
