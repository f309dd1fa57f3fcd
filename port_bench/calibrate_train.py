"""Readings that a training cell's limits for `correct` are set from.

    python -m port_bench.calibrate_train --workload W --seeds 11,12,... \
        --control-seeds 21,22,23 [--steps 100] [--out readings.jsonl]

In one process, for each seed: the seeded weights and a fresh trainer, the
checked first steps through the cell's own call at its own sizes
(`warm_up`), `--steps` more steps as a window would take them, the late
checked step after them (`settle`), then the float32 reference of both
(`reference`) and the compared numbers (`numbers`). The `ema` reading of a
skipped update (the EMA left as it was) comes with it. For each control
seed also, both in the program's place and judged against the float32
reference as the program is:
- the control: the reference with every product's operands in float8 e4m3
  (the step below the bf16 the configuration states);
- the fault that leaves half the batch out, the loss's mean taken over the
  rest.
For each witness seed, the reference with its products' operands in
bfloat16 (the configuration's precision) in the program's place: what that
rounding alone reads. Each reading names the leaves that read worst in
`grad` and `late_grad_worst`. One JSON line per reading on standard
output, and appended to `--out` when given. Needs the card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from contextlib import nullcontext

import torch

from port_bench import registry, traffic
from port_bench.reference import numerics


def tf32_flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def set_tf32_flags(flags):
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def in_place(drv, config, mix, seed, device, request_of, found, **kwargs):
    """The reference's readings, computed as `kwargs` say, in the program's place."""
    n = mix['checked_steps']
    late = found['late']
    return dict(first=drv.follow(config, mix, seed, device,
                                 [request_of(k - n) for k in range(n)], **kwargs),
                late=drv.follow_late(config, mix, device, late['start'],
                                     request_of(late['at']), **kwargs))


def worst_leaves(ours, theirs, n=3):
    """[(name, gap over the floor, ours, theirs, floor)] of the `n` leaves
    whose gradient norms differ most (see `numbers`)."""
    floor = statistics.median(theirs.values())
    gaps = [(k, abs(ours[k] - theirs[k]) / max(theirs[k], floor), ours[k], theirs[k], floor)
            for k in theirs]
    return sorted(gaps, key=lambda g: -g[1])[:n]


def leaves(ours, theirs):
    return dict(grad_leaves=worst_leaves(ours['first']['grads'], theirs['first']['grads']),
                late_grad_leaves=worst_leaves(ours['late']['grads'], theirs['late']['grads']))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', default='')
    parser.add_argument('--control-seeds', default='')
    parser.add_argument('--witness-seeds', default='')
    parser.add_argument('--steps', type=int, default=100)
    parser.add_argument('--out', default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA device')
    device = torch.device('cuda', 0)
    cell = registry.workload(args.workload)
    config, mix = registry.config(cell['config']), registry.traffic(cell['traffic'])
    drv = registry.system(mix['system'])
    system = drv.build(config, mix, device)
    program_flags = tf32_flags()

    def emit(**row):
        line = json.dumps(dict(row, workload=args.workload, device=torch.cuda.get_device_name()))
        print(line, flush=True)
        if args.out:
            with open(args.out, 'a') as log:
                log.write(line + '\n')

    seeds = [int(s) for s in args.seeds.split(',') if s]
    control = [int(s) for s in args.control_seeds.split(',') if s]
    witness = [int(s) for s in args.witness_seeds.split(',') if s]
    for seed in dict.fromkeys(seeds + control + witness):
        def request_of(i, seed=seed):
            return traffic.request(mix, config, seed, i, device)

        set_tf32_flags(program_flags)
        drv.load_weights(system, seed, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        drv.warm_up(system, request_of)
        for i in range(args.steps):
            drv.serve(system, request_of(i))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated(device)
        drv.settle(system, request_of, args.steps)
        found = drv.findings(system, [], {})
        late_step = int(found['late']['start']['step']) + 1
        system.trainer = None
        system.targets = {}
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        theirs = drv.reference(config, mix, seed, device, request_of, found)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        emit(kind='program', seed=seed, steps_s=(t1 - t0) / (args.steps + mix['checked_steps']),
             reference_s=t3 - t2, peak_gib=peak / 2 ** 30, late_step=late_step,
             losses=found['first']['losses'] + found['late']['losses'],
             ref_losses=theirs['first']['losses'] + theirs['late']['losses'],
             ema_unchanged=theirs['late']['ema_unchanged'], **drv.numbers(found, theirs),
             **leaves(found, theirs))
        kinds = ([('control', 'fp8', {}), ('half_batch', None, dict(used=mix['prompts'] // 2))]
                 if seed in control else []) + ([('bf16', 'bf16', {})] if seed in witness else [])
        for kind, rounding, how in kinds:
            with numerics.precision(rounding) if rounding else nullcontext():
                ours = in_place(drv, config, mix, seed, device, request_of, found, **how)
            out = drv.numbers(ours, theirs)
            out.pop('ema')
            emit(kind=kind, seed=seed, **out, **leaves(ours, theirs))
        del theirs, found
        torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
