"""Each per-layer reader fed a synthetic trace whose answers are known."""
from __future__ import annotations

import json

import pytest

from port_bench import registry, roofline
from port_bench.run import Record
from port_bench.trace import Trace, category


def span(name, ts, dur):
    return dict(ph='X', cat='user_annotation', name=name, pid=1, tid=1, ts=ts, dur=dur)


def launch(corr, ts):
    return dict(ph='X', cat='cuda_runtime', name='cudaLaunchKernel', pid=1, tid=1, ts=ts,
                dur=1, args=dict(correlation=corr))


def kernel(corr, ts, dur, name='void conv2d_same_3x3_kernel<>', cat='kernel'):
    return dict(ph='X', cat=cat, name=name, pid=0, tid=7, ts=ts, dur=dur,
                args=dict(correlation=corr))


def synthetic():
    """A slice of 1000 us: one request, one U-Net forward with two conv
    sites and one attention site, one thresholding call; times in us."""
    events = [span('pb.slice', 0, 1000), span('pb.request', 0, 990),
              span('pb.unet0', 10, 600),
              span('pb.site.conv3x3_roofline:0', 20, 50),
              span('pb.site.conv3x3_roofline:1', 100, 50),
              span('pb.site.attn_roofline:0', 200, 40),
              span('pb.call.sample.threshold_ms', 700, 30)]
    launches = [(1, 25), (2, 30), (3, 110), (4, 210), (5, 710), (6, 800)]
    events += [launch(c, t) for c, t in launches]
    events += [kernel(1, 100, 100), kernel(2, 200, 50), kernel(3, 300, 200),
               kernel(4, 500, 100, name='flash_rows_fwd_kernel'),
               kernel(5, 720, 80, name='kthvalue'),
               kernel(6, 850, 50, name='Memcpy DtoH', cat='gpu_memcpy')]
    return events


@pytest.fixture
def run(tmp_path):
    path = tmp_path / 'trace.json'
    path.write_text(json.dumps(dict(traceEvents=synthetic())))
    config = dict(flops_per_row=[2e12, 0])
    record = Record(config, {}, latencies=[float(i) for i in range(1, 11)], images=20,
                    window_s=10., forward_rows=[(0, 16)] * 10, peak_bytes=3 * 2 ** 30,
                    trace=Trace.load(path), slice_requests=1, slice_forwards=2)
    record.sites = {'conv3x3_roofline': [(989e12 * 100e-6, 0), (0, 3.35e12 * 50e-6)],
                    'attn_roofline': [(989e12 * 25e-6, 0)]}
    return record


def read(name, run):
    return registry.metric(name).read(run)


def test_the_trace_reader(run):
    trace = run.trace
    assert trace.window_s == pytest.approx(1000e-6)
    assert trace.kernels() == 5
    assert trace.busy_s() == pytest.approx(580e-6)
    spent = trace.device_seconds_in('pb.site.conv3x3_roofline')
    assert spent == pytest.approx({'pb.site.conv3x3_roofline:0': 150e-6,
                                   'pb.site.conv3x3_roofline:1': 200e-6})
    assert dict(trace.by_category())['port kernels'] == pytest.approx(450e-6)
    idle = dict(trace.idle_by_span())
    # the gaps at 0, 800 and 900 us fall in the request, those at 250 and 600 in the forward
    assert idle == pytest.approx({'pb.request': 250e-6, 'pb.unet0': 170e-6})
    assert category('volta_sgemm_128x64') == 'GEMM'


def test_the_readers(run):
    assert read('conv3x3_roofline', run) == pytest.approx(100 * 150e-6 / 350e-6)
    assert read('attn_roofline', run) == pytest.approx(25.)
    assert read('sample.threshold_ms', run) == pytest.approx(0.08)
    assert read('unet.launches_per_fwd', run) == pytest.approx(2.5)
    # 580 us busy in the one request of the slice, against a median request of 5.5 s
    assert read('device.idle_share', run) == pytest.approx(100 * (1 - 580e-6 / 5.5))
    assert read('device.peak_gib', run) == pytest.approx(3.)
    assert read('request.p90_s', run) == pytest.approx(9.1)
    assert read('step_mfu', run) == pytest.approx(100 * 160 * 2e12 / (10 * roofline.PEAK_FLOPS))


def test_a_reader_with_nothing_to_read_returns_nothing(run):
    run.trace = Trace([])
    run.sites = {}
    for name in ('conv3x3_roofline', 'attn_roofline', 'sample.threshold_ms',
                 'unet.launches_per_fwd', 'device.idle_share'):
        assert read(name, run) is None, name


def training_slice():
    """Two training steps of 1000 us: each a `_backward` span holding a U-Net
    forward, then the optimiser's step and the EMA call, which updates in the
    second step only; times in us."""
    events = [span('pb.slice', 0, 2000)]
    launches, kernels = [], []
    for k, at in enumerate((0, 1000)):
        events += [span('pb.request', at, 990), span('pb.call.train.backward_ms', at + 10, 600),
                   span('pb.unet0', at + 20, 200), span('pb.call.train.optimizer_ms', at + 700, 100),
                   span('pb.call.train.ema_ms', at + 850, 50)]
        corr = 10 * k
        launches += [(corr + 1, at + 30), (corr + 2, at + 300), (corr + 3, at + 710)]
        kernels += [kernel(corr + 1, at + 40, 100, name='flash_rows_fwd_kernel'),
                    kernel(corr + 2, at + 320, 250, name='flash_rows_bwd_dq_kernel'),
                    kernel(corr + 3, at + 720, 60, name='multi_tensor_apply_kernel')]
    launches.append((30, 1860))
    kernels.append(kernel(30, 1870, 20, name='vectorized_elementwise_kernel'))
    return events + [launch(c, t) for c, t in launches] + kernels


def test_the_training_readers(tmp_path):
    path = tmp_path / 'trace.json'
    path.write_text(json.dumps(dict(traceEvents=training_slice())))
    mix = dict(unet_number=1, train_flops_per_row=3e12)
    run = Record({}, mix, latencies=[1.] * 5, images=160, window_s=10., trace=Trace.load(path),
                 slice_requests=2)
    # the backward span less its nested forward: 250 us a step
    assert read('train.backward_ms', run) == pytest.approx(0.25)
    assert read('train.optimizer_ms', run) == pytest.approx(0.06)
    # one EMA call of two launched anything
    assert read('train.ema_ms', run) == pytest.approx(0.02)
    assert read('train.step_mfu', run) == pytest.approx(100 * 160 * 3e12 / (10 * 989e12))
    assert category('radix_select_kernel<0, false, 4>') == 'port kernels'
    assert category('multi_tensor_apply_kernel') == 'optimizer'
    run.trace, run.mix = Trace([]), {}
    for name in ('train.backward_ms', 'train.optimizer_ms', 'train.ema_ms', 'train.step_mfu'):
        assert read(name, run) is None, name
