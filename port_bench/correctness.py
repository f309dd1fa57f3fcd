"""The numbers that decide `correct`, and the judgement against a cell's limits.

A checked request's answer is judged by the reference following the
sampler's own states (`reference.ddpm.follow`): with random weights a
trajectory is chaotic, so each step is computed again from the program's
state before it. The numbers, in the units of the sampler's state ([-1, 1]):
- `start`: the largest difference of a stage's initial image from the
  reference's draw of it (an exact comparison);
- `step_rms`: the largest, over the steps and the images, of one image's
  root mean square difference between the program's step and the
  reference's step from the same state;
- `step_max`: the largest difference of any pixel of any step;
- `answer`: the largest difference of a served pixel from the image that
  the last state gives, in [0, 1] (an exact comparison).
A cell's file (`port_bench/cells/<workload>.json`) gives the limit of each
number it compares and the readings the limit was set from. An answer of
the wrong shape, or with a value that is not finite or outside [0, 1],
fails every number.
"""
from __future__ import annotations

import math

import torch

FAILED = dict(start=math.inf, step_rms=math.inf, step_max=math.inf, answer=math.inf)


def numbers(served, followed):
    """The numbers of one request: `served` its images on the host,
    `followed` what `ddpm.follow` made of its states."""
    start, errors, answer = followed
    if (served.shape != answer.shape or not torch.isfinite(served).all()
            or served.min() < 0 or served.max() > 1):
        return dict(FAILED)
    step_rms = step_max = 0.
    for _, _, err in errors:
        if not torch.isfinite(err).all():
            return dict(FAILED)
        per_image = err.double().pow(2).flatten(1).mean(dim=1).sqrt()
        step_rms = max(step_rms, per_image.max().item())
        step_max = max(step_max, err.abs().max().item())
    return dict(start=start, step_rms=step_rms, step_max=step_max,
                answer=(served.double() - answer.double().cpu()).abs().max().item())


def worst(readings):
    """The largest of each number over several requests."""
    return {k: max(r[k] for r in readings) for k in readings[0]}


def judge(found, limits):
    """(correct, {name: {'value', 'limit'}}) for the numbers that have a limit."""
    checks = {name: dict(value=found[name], limit=entry['limit'])
              for name, entry in limits.items()}
    ok = all(c['value'] <= c['limit'] for c in checks.values())
    return ok, checks
