"""One run of one cell of the benchmark of `imagen_tpu_torch`.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cell's cards. Set-up
builds the program from the cell's configuration, makes its weights on the
card from the seed, and runs the program's own warm-up at the cell's shapes.
The window then serves the mix's requests in a closed loop, one client and
one request at a time, for `--seconds` (the request in flight at the close
finishes). With `--trace 0` the result holds the end-to-end metrics;
with `--trace 1` the per-layer ones, which need hooks during the window and
then a profiled slice of whole requests. After the window the program is
freed and the plain reference judges what the system kept for the check:
a sampling system (`port_bench/systems/imagen_sample.py`) the checked
requests, drawn from the seed, step by step (`port_bench/correctness.py`); a
training system (`port_bench/systems/imagen_train.py`) set-up's first steps
and one step after the window. The system adapter picks its warm-up, the
requests the window keeps, what it finishes after the window and how it is
judged. The last line of standard
output is the result as JSON; the compared numbers and their limits are the
last lines of standard error. A run without the cards it asks for, or that
finds JAX or the JAX package loaded, exits non-zero and prints no result.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'imagen_tpu')
ROOT = Path(__file__).resolve().parent.parent
SLICE_SPAN = 'pb.slice'


def pin_caches(root):
    """Every build and kernel cache inside the checkout, at fixed paths; no
    library that the program loads may bring in JAX or Flax."""
    build = Path(root) / 'build' / 'port_bench'
    os.environ['TRITON_CACHE_DIR'] = str(build / 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = str(build / 'torch_extensions')
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_TF'] = '0'


@dataclass
class Record:
    """What a run measured, for the per-layer readers (`port_bench/metrics/`)."""
    config: dict
    mix: dict
    latencies: list = field(default_factory=list)   # seconds a request, in the window
    images: int = 0
    window_s: float = 0.                            # window start to the last completion
    forward_rows: list = field(default_factory=list)  # (stage, rows) of each U-Net forward
    peak_bytes: int = 0
    trace: object = None
    slice_requests: int = 0
    slice_forwards: int = 0
    sites: dict = field(default_factory=dict)       # metric -> [(flops, bytes)] by site


def parse(argv):
    parser = argparse.ArgumentParser(description='one run of one benchmark cell')
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def forbidden_modules():
    return sorted({name.split('.')[0] for name in sys.modules} & set(FORBIDDEN))


class Hooks:
    """The harness's own instrumentation of the program: forward hooks on the
    U-Nets (rows counted; in the slice, a span each), and in the slice the
    per-layer metrics' site spans and method spans."""

    def __init__(self, torch, system, record):
        self.torch, self.system, self.record = torch, system, record
        self.handles, self.spans, self.slice = [], [], False
        for stage, unet in enumerate(system.imagen.unets):
            if unet in system.unets:
                self.handles.append(unet.register_forward_pre_hook(self._unet_pre(stage)))
                self.handles.append(unet.register_forward_hook(self._close))

    def _open(self, name):
        span = self.torch.profiler.record_function(name)
        span.__enter__()
        self.spans.append(span)

    def _close(self, *_):
        if self.slice:
            self.spans.pop().__exit__(None, None, None)

    def _unet_pre(self, stage):
        def hook(module, args):
            if self.slice:
                self.record.slice_forwards += 1
                self._open(f'pb.unet{stage}')
            else:
                self.record.forward_rows.append((stage, args[0].shape[0]))
        return hook

    def trace_sites(self, readers):
        """Spans for every site and method the readers name."""
        self.slice = True
        for metric, reader in readers.items():
            sites = getattr(reader, 'SITES', {})
            if sites:
                self.record.sites[metric] = []
            for unet in self.system.unets:
                for module in unet.modules():
                    work = sites.get(type(module).__name__)
                    if work is not None:
                        self._watch(module, metric, work)
            target = getattr(reader, 'TARGET', None)
            if target is None or target in getattr(self.system, 'targets', {}):
                for method in getattr(reader, 'METHODS', ()):
                    self._wrap(target, method, f'pb.call.{metric}')

    def _watch(self, module, metric, work):
        works = self.record.sites[metric]

        def pre(mod, args, kwargs):
            self._open(f'pb.site.{metric}:{len(works)}')
            works.append(None)

        def post(mod, args, kwargs, output):
            works[-1] = work(mod, args, kwargs, output)
            self._close()

        self.handles.append(module.register_forward_pre_hook(pre, with_kwargs=True))
        self.handles.append(module.register_forward_hook(post, with_kwargs=True))

    def _wrap(self, target, method, name):
        """A span around `method` of the cascade, or of the system's `targets[target]`."""
        target = self.system.imagen if target is None else self.system.targets[target]
        inner = getattr(target, method)
        torch = self.torch

        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(name):
                return inner(*args, **kwargs)

        setattr(target, method, wrapped)
        self.handles.append(_Restore(target, method, inner))

    def remove(self):
        for handle in self.handles:
            handle.remove()
        self.handles = []


@dataclass
class _Restore:
    target: object
    method: str
    inner: object

    def remove(self):
        setattr(self.target, self.method, self.inner)


def traced_slice(torch, drv, system, mix, config, seed, first, readers, record, device, root):
    """Profile `trace_requests` whole requests after the window; returns the Trace."""
    from port_bench.trace import Trace
    from port_bench import traffic
    hooks = Hooks(torch, system, record)
    hooks.trace_sites(readers)
    requests = [traffic.request(mix, config, seed, first + i, device)
                for i in range(mix['trace_requests'])]
    path = Path(root) / 'build' / 'port_bench' / 'trace.json'
    path.parent.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == 'cuda':
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        with torch.profiler.profile(activities=activities) as prof:
            with torch.profiler.record_function(SLICE_SPAN):
                for request in requests:
                    with torch.profiler.record_function('pb.request'):
                        drv.serve(system, request)
                sync(torch, device)
        record.slice_requests = len(requests)
        prof.export_chrome_trace(str(path))
        return Trace.load(path)
    finally:
        hooks.remove()
        path.unlink(missing_ok=True)


def sync(torch, device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def run(argv=None, *, root=ROOT, device=None):
    """One run; returns the exit code. `device` set (a test's CPU) skips the
    look for the cards."""
    args = parse(argv)
    pin_caches(root)
    from port_bench import registry
    cell = registry.workload(args.workload, root)
    config, mix = registry.config(cell['config'], root), registry.traffic(cell['traffic'], root)
    limits = registry.cell(args.workload, root)['limits']

    import torch
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell['chips']:
            print(f'{args.workload} needs {cell["chips"]} CUDA device(s); found '
                  f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
                  file=sys.stderr)
            return 2
        device = torch.device('cuda', 0)

    from port_bench import correctness, traffic
    drv = registry.system(mix['system'], root)
    readers = {m['name']: registry.metric(m['name'], root)
               for m in registry.per_layer(args.workload, root)} if args.trace else {}
    record = Record(config, mix)

    def request_of(i):
        return traffic.request(mix, config, args.seed, i, device)

    # --- set-up: build, weights from the seed, the program's own warm-up
    phases = [('imports', time.perf_counter() - T0)]
    system = drv.build(config, mix, device)
    phases.append(('build', time.perf_counter() - T0))
    drv.load_weights(system, args.seed, device)
    sync(torch, device)
    phases.append(('weights', time.perf_counter() - T0))
    drv.warm_up(system, request_of)
    sync(torch, device)
    phases.append(('warm-up', time.perf_counter() - T0))
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - T0

    # --- the window: a closed loop of one client
    check = drv.checked(args.seed, mix)
    kept, failed, index = {}, 0, 0
    hooks = Hooks(torch, system, record) if args.trace else None
    w0 = time.perf_counter()
    last = w0
    while True:
        request = request_of(index)
        states = [] if index in check else None
        sent = time.perf_counter()
        try:
            images = drv.serve(system, request, states)
        except Exception:   # a failed request counts, and the run is not correct
            print(f'request {index} failed:', file=sys.stderr)
            traceback.print_exc()
            failed, images = failed + 1, None
        last = time.perf_counter()
        record.latencies.append(last - sent)
        if images is not None:
            record.images += images.shape[0]
            if states is not None:
                kept[index] = (images, [[x.cpu() for x in trail] for trail in states])
        index += 1
        if last - w0 >= args.seconds:
            break
    record.window_s = last - w0
    attempted = index
    print('set-up ends (s): ' + ', '.join(f'{k} {v:.3f}' for k, v in phases), file=sys.stderr)
    print('request latencies (s): ' + ' '.join(f'{x:.4f}' for x in record.latencies),
          file=sys.stderr)
    if hooks:
        hooks.remove()
        hooks = None   # it holds the system, which the check frees
    # an answer still due is waited for, up to a minute past the close
    while any(i not in kept for i in check) and time.perf_counter() - last < 60:
        states = []
        images = drv.serve(system, request_of(index), states)
        if index in check:
            kept[index] = (images, [[x.cpu() for x in trail] for trail in states])
        index += 1
    if device.type == 'cuda':
        record.peak_bytes = torch.cuda.max_memory_allocated(device)
    index = drv.settle(system, request_of, index)

    if args.trace:
        record.trace = traced_slice(torch, drv, system, mix, config, args.seed, index, readers,
                                    record, device, root)

    # --- the check: the program freed, the reference follows what the system kept
    found = drv.findings(system, check, kept)
    del system
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    readings = drv.judge(config, mix, args.seed, device, request_of, found)
    correct, checks = correctness.judge(correctness.worst(readings), limits)
    correct = correct and failed == 0

    if args.trace:
        metrics = {}
        for m in registry.per_layer(args.workload, root):
            value = readers[m['name']].read(record)
            if value is not None:
                metrics[m['name']] = dict(value=value, unit=m['unit'])
    else:
        found = dict(images_per_s=record.images / record.window_s, setup_s=setup_s)
        metrics = {m['name']: dict(value=found[m['name']], unit=m['unit'])
                   for m in registry.end_to_end(args.workload, root)}

    bad = forbidden_modules()
    if bad:
        print(f'loaded in this process: {", ".join(bad)}', file=sys.stderr)
        return 3

    result = dict(correct=bool(correct), attempted=attempted, failed=failed, metrics=metrics,
                  device=device_info(torch, device, cell['chips'], record.peak_bytes))
    if args.trace and record.trace is not None:
        result['device'].update(busy_s=record.trace.busy_s(), window_s=record.trace.window_s)
        result['breakdown'] = dict(device_ops=record.trace.by_category(),
                                   idle_gaps=record.trace.idle_by_span())
    result['checks'] = checks
    for name, c in checks.items():
        print(f'check {name}: {c["value"]!r} limit {c["limit"]!r}', file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def device_info(torch, device, count, peak):
    if device.type != 'cuda':
        return dict(platform='cpu', kind='cpu', count=count, memory_peak_bytes=peak)
    return dict(platform='gpu', kind=torch.cuda.get_device_name(device), count=count,
                memory_peak_bytes=peak)


if __name__ == '__main__':
    sys.exit(run())
