"""Reads the profiler's Chrome trace of a run's traced slice.

The harness opens host spans (`torch.profiler.record_function`) named
`pb.<what>` or `pb.<what>:<k>` around the calls it watches, and one span
`pb.slice` around the whole traced slice. A device operation (a kernel, a
copy or a fill) belongs to the innermost span of a prefix that was open
when the host launched it: the trace ties each device operation to its
launch by the `correlation` id. Times are in seconds.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')

# The device operations' categories, by name, first match wins (a frozen copy
# of the table that `imagen_tpu_torch/profile_serving.py` used, with the
# radix select among the port's kernels).
CATEGORIES = (
    ('port kernels', ('conv2d_same_3x3', 'flash_rows_', 'fused_feedforward', 'temporal_attn',
                      'ln_relayout', 'film_norm', 'layernorm_rows', 'ln_matmul',
                      'cross_embed', 'conv2d_same_cf', 'radix_select')),
    ('optimizer', ('multi_tensor', 'adam')),
    ('cuDNN conv', ('conv', 'xmma', 'implicit', 'cudnn', 'winograd')),
    ('GEMM', ('gemm', 'cutlass', 'nvjet', 'cublas')),
    ('copy / cast', ('copy', 'memcpy', 'memset', 'cat', 'pad')),
    ('reduction', ('reduce', 'softmax', 'norm', 'kthvalue', 'sort')),
    ('elementwise', ('elementwise', 'vectorized', 'unrolled')),
)


def category(name):
    low = name.lower()
    for label, keys in CATEGORIES:
        if any(k in low for k in keys):
            return label
    return 'other'


class Trace:
    """The device operations and the harness's spans of one traced slice."""

    def __init__(self, events):
        launches, self.spans, self.ops = {}, [], []
        for e in events:
            if e.get('ph') != 'X':
                continue
            cat = e.get('cat', '')
            if cat in DEVICE_CATS:
                self.ops.append((e['ts'] * 1e-6, e.get('dur', 0) * 1e-6, e.get('name', ''),
                                 (e.get('args') or {}).get('correlation'), cat))
            elif cat.startswith('cuda_'):   # a CUDA API call on the host
                corr = (e.get('args') or {}).get('correlation')
                if corr is not None:
                    launches[corr] = e['ts'] * 1e-6
            elif cat == 'user_annotation' and str(e.get('name', '')).startswith('pb.'):
                self.spans.append((e['name'], e['ts'] * 1e-6, e.get('dur', 0) * 1e-6))
        self.ops.sort()
        # each device op's launch time on the host (None where the trace lacks it)
        self.launched = [launches.get(corr) for _, _, _, corr, _ in self.ops]
        slices = [s for s in self.spans if s[0] == 'pb.slice']
        if slices:
            _, start, dur = slices[0]
        elif self.ops:
            start = self.ops[0][0]
            dur = max(ts + d for ts, d, *_ in self.ops) - start
        else:
            start, dur = 0., 0.
        self.start, self.window_s = start, dur

    @classmethod
    def load(cls, path):
        with open(path) as f:
            data = json.load(f)
        return cls(data['traceEvents'] if isinstance(data, dict) else data)

    def spans_of(self, prefix):
        """[(name, start, end)] of the spans whose name is `prefix` or starts
        with `prefix:`, by start."""
        return sorted((n, s, s + d) for n, s, d in self.spans
                      if n == prefix or n.startswith(prefix + ':'))

    def device_seconds_in(self, prefix):
        """{span name: seconds of device operations launched inside it} for
        spans of `prefix`, which must not nest in one another."""
        out = defaultdict(float)
        for (name, _, _), spent in zip(self.spans_of(prefix), self.device_seconds_each(prefix)):
            if spent:
                out[name] += spent
        return dict(out)

    def device_seconds_each(self, prefix):
        """[seconds of device operations launched inside each span] for the
        spans of `prefix` (which must not nest), by start."""
        spans = self.spans_of(prefix)
        starts = [s for _, s, _ in spans]
        out = [0.] * len(spans)
        for (ts, dur, *_), at in zip(self.ops, self.launched):
            if at is None:
                continue
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at <= spans[i][2]:
                out[i] += dur
        return out

    def kernels(self):
        """The number of kernels (not copies or fills) in the slice."""
        return sum(1 for op in self.ops if op[4] == 'kernel')

    def busy_intervals(self):
        """The union of the device operations' intervals inside the slice."""
        lo, hi = self.start, self.start + self.window_s
        merged = []
        for ts, dur, *_ in self.ops:
            a, b = max(ts, lo), min(ts + dur, hi)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self):
        return sum(b - a for a, b in self.busy_intervals())

    def by_category(self, top=10):
        """[[category, device seconds]], the largest first."""
        sums = defaultdict(float)
        for _, dur, name, *_ in self.ops:
            sums[category(name)] += dur
        return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:top]]

    def idle_by_span(self, top=10):
        """[[span, idle device seconds]]: each gap between device operations
        inside the slice, charged to the innermost `pb.` span open on the
        host when the gap began (its `:k` suffix dropped), the largest first."""
        busy = self.busy_intervals()
        edges = [self.start] + [x for a, b in busy for x in (a, b)] + [
            self.start + self.window_s]
        # host spans nest, so those open at a time form a stack
        spans = sorted((s, s + d, n.split(':')[0]) for n, s, d in self.spans
                       if n != 'pb.slice')
        sums, stack, j = defaultdict(float), [], 0
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            while j < len(spans) and spans[j][0] <= a:
                while stack and stack[-1][1] < spans[j][0]:
                    stack.pop()
                stack.append(spans[j])
                j += 1
            while stack and stack[-1][1] < a:
                stack.pop()
            sums[stack[-1][2] if stack else 'pb.slice'] += b - a
        return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:top]]
