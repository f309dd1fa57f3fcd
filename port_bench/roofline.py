"""The chip's peaks and the least time of a piece of work on it.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, without
sparsity): 989 TFLOP/s in bf16 on the tensor cores and 3.35 TB/s of HBM3.
A site's least time is the larger of its operations over the FLOP peak and
its bytes over the byte peak, with each input read once and each output
written once (`chip_smoke.py`'s rule). Operations count 2 per multiply-add.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def least_seconds(flops, nbytes):
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def _bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _param_bytes(module):
    return sum(p.numel() * p.element_size() for p in module.parameters())


def conv3x3(module, args, kwargs, output):
    """A 3x3 SAME conv on NHWC x (b, H, W, cin) to cout channels."""
    x = args[0]
    b, h, w, cin = x.shape
    flops = 2 * b * h * w * 9 * cin * module.out_channels
    return flops, _bytes(x, output) + _param_bytes(module)


def self_attention(module, args, kwargs, output):
    """Multi-query attention of x (b, n, dim) with a null key and value and,
    with `context` (b, nc, cd), its projected keys and values in front: the
    q, kv, context and out projections and both attention products."""
    x = args[0]
    context = kwargs.get('context', args[1] if len(args) > 1 else None)
    b, n, dim = x.shape
    dh = module.null_kv.shape[-1]
    inner = module.to_q.out_features
    heads = inner // dh
    nk = n + 1
    flops = 2 * b * n * dim * inner + 2 * b * n * dim * 2 * dh + 2 * b * n * inner * dim
    if context is not None:
        nc, cd = context.shape[1], context.shape[2]
        nk += nc
        flops += 2 * b * nc * cd * 2 * dh
    flops += 4 * b * heads * n * nk * dh
    return flops, _bytes(x, context, output) + _param_bytes(module)


def cross_attention(module, args, kwargs, output):
    """Multi-head attention of x (b, n, dim) over `context` (b, nc, cd) with
    a null key and value: the q, kv and out projections and both products."""
    x = args[0]
    context = kwargs.get('context', args[1] if len(args) > 1 else None)
    b, n, dim = x.shape
    nc, cd = context.shape[1], context.shape[2]
    dh = module.null_kv.shape[-1]
    inner = module.to_q.out_features
    heads = inner // dh
    flops = (2 * b * n * dim * inner + 2 * b * nc * cd * 2 * inner
             + 4 * b * heads * n * (nc + 1) * dh + 2 * b * n * inner * dim)
    return flops, _bytes(x, context, output) + _param_bytes(module)


def site_roofline(run, metric):
    """100 x the sites' least time over the device time of the operations
    launched inside them, for the sites of `metric` that launched any; None
    where none did."""
    spent = run.trace.device_seconds_in(f'pb.site.{metric}') if run.trace else {}
    if not spent or sum(spent.values()) <= 0:
        return None
    work = run.sites[metric]
    bound = sum(least_seconds(*work[int(name.rsplit(':', 1)[1])]) for name in spent)
    return 100. * bound / sum(spent.values())
