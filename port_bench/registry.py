"""Finds every part of the benchmark by the name `BENCHMARK.json` gives it.

A configuration is `port_bench/configs/<name>.json`, a traffic mix
`port_bench/traffic/<name>.json`, a cell's limits for `correct`
`port_bench/cells/<workload>.json`, a per-layer metric's reader
`port_bench/metrics/<metric>.py` and the code that drives a kind of entry
`port_bench/systems/<system>.py`, all under the checkout's root. A new cell,
configuration, mix or metric is new files and new entries; no file here
names one.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return _json(Path(root) / 'BENCHMARK.json')


def workload(name, root=ROOT):
    """The `workloads` entry called `name`."""
    for entry in benchmark(root)['workloads']:
        if entry['name'] == name:
            return entry
    raise KeyError(f'no workload {name!r} in BENCHMARK.json')


def config(name, root=ROOT):
    return _json(Path(root) / 'port_bench' / 'configs' / f'{name}.json')


def traffic(name, root=ROOT):
    return _json(Path(root) / 'port_bench' / 'traffic' / f'{name}.json')


def cell(name, root=ROOT):
    return _json(Path(root) / 'port_bench' / 'cells' / f'{name}.json')


def _module(path, label):
    spec = importlib.util.spec_from_file_location(label, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[label] = module
    spec.loader.exec_module(module)
    return module


def metric(name, root=ROOT):
    """The reader module of per-layer metric `name`."""
    return _module(Path(root) / 'port_bench' / 'metrics' / f'{name}.py',
                   f'port_bench_metric_{name.replace(".", "_")}')


def system(name, root=ROOT):
    """The adapter that builds and drives one kind of system under test."""
    return _module(Path(root) / 'port_bench' / 'systems' / f'{name}.py',
                   f'port_bench_system_{name}')


def per_layer(workload_name, root=ROOT):
    """The per-layer metric entries that `workload_name` reports."""
    bench = benchmark(root)
    reported = {m['name'] for m in bench['end_to_end']
                if workload_name in m.get('workloads', [workload_name])}
    return [m for m in bench['per_layer']
            if m['moves'] in reported and workload_name in m.get('workloads', [workload_name])]


def end_to_end(workload_name, root=ROOT):
    return [m for m in benchmark(root)['end_to_end']
            if workload_name in m.get('workloads', [workload_name])]
