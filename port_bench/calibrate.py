"""Readings that a cell's limits for `correct` are set from.

    python -m port_bench.calibrate --workload W --seeds 11,12,... --control-seeds 21,22,23 \
        [--out readings.jsonl]

For each seed: the cell's weights, the requests a run checks (the first
`check_requests` of the mix), served by the program through the cell's own
entry at its own sizes with their states recorded, then the float32
reference following those states, and the compared numbers
(`correctness.numbers`). For each control seed also the control: the
reference with every product's operands in float8 e4m3 (the step below the
bf16 the configuration states) sampling in the program's place, judged the
same way. One JSON line per reading on standard output, and appended to
`--out` when given. Needs the card.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from port_bench import correctness, registry, traffic


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', default='')
    parser.add_argument('--control-seeds', default='')
    parser.add_argument('--out', default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA device')
    device = torch.device('cuda')
    cell = registry.workload(args.workload)
    config, mix = registry.config(cell['config']), registry.traffic(cell['traffic'])
    drv = registry.system(mix['system'])
    system = drv.build(config, mix, device)

    def emit(**row):
        line = json.dumps(dict(row, workload=args.workload, device=torch.cuda.get_device_name()))
        print(line, flush=True)
        if args.out:
            with open(args.out, 'a') as log:
                log.write(line + '\n')

    seeds = [int(s) for s in args.seeds.split(',') if s]
    control = [int(s) for s in args.control_seeds.split(',') if s]
    warmed = False
    for seed in dict.fromkeys(seeds + control):
        drv.load_weights(system, seed, device)
        requests = [traffic.request(mix, config, seed, i, device)
                    for i in range(mix['check_requests'])]
        if not warmed:
            drv.warm(system, requests[0])
            warmed = True
        t0 = time.perf_counter()
        served = []
        for r in requests:
            states = []
            out = drv.serve(system, r, states)
            served.append((out, [[x.cpu() for x in trail] for trail in states]))
        t1 = time.perf_counter()
        unets = drv.reference_unets(config, seed, device)
        if seed in seeds:
            found = correctness.worst([
                correctness.numbers(out, drv.follow(unets, config, mix, r, states))
                for r, (out, states) in zip(requests, served)])
            torch.cuda.synchronize()
            emit(kind='program', seed=seed, serve_s=t1 - t0,
                 follow_s=time.perf_counter() - t1, **found)
        if seed in control:
            t2 = time.perf_counter()
            readings = []
            for r in requests:
                out, states = drv.control(unets, config, mix, r)
                readings.append(correctness.numbers(
                    out, drv.follow(unets, config, mix, r, states)))
            torch.cuda.synchronize()
            emit(kind='control', seed=seed, control_s=time.perf_counter() - t2,
                 **correctness.worst(readings))
        del unets
        torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
