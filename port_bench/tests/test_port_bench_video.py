"""The video cell's harness on the CPU at a tiny size: its files parse and are
found by name, a tiny clip served through `run.py`'s path judges `correct`
and fails with one step perturbed, and the three temporal readers return
numbers from a tiny traced run and a synthetic trace."""
from __future__ import annotations

import copy
import json
import shutil

import pytest
import torch

from port_bench import registry, run as runner
from port_bench.run import Record
from port_bench.tests import tiny
from port_bench.tests.test_port_bench_trace import kernel, launch, span
from port_bench.trace import Trace

SEED = 2 ** 31 + 23
CELLS = {'video64-serve-f16': ('unet3d-64-f16', 'video-f16-b1'),
         'cascade256-serve-b1': ('imagen-64-256', 'cascade-b1')}
READERS = ('video.temporal_ms', 'temporal_attn_roofline', 'temporal_attn.kernel_share')


def tiny_video_config():
    """`unet3d-64-f16` with every width cut: 4 frames of 16 px, 3 steps."""
    config = copy.deepcopy(registry.config('unet3d-64-f16'))
    config['unets'][0].update(dim=16, dim_mults=[1, 2], num_resnet_blocks=1,
                              layer_attns=[False, True], layer_cross_attns=[False, True],
                              attn_heads=2, attn_dim_head=8, attn_pool_num_latents=4)
    config.update(name='tiny', image_sizes=[16], frames=4, timesteps=[3], text_embed_dim=12,
                  max_text_len=6, compute_dtype='float32')
    return config


def make_video_root(tmp):
    """A root whose BENCHMARK.json names one cell, `tiny-video`, the tiny
    video configuration served on the video mix, with the real adapters and
    readers copied beside it."""
    root = tmp
    bench = registry.benchmark()
    bench['configs'] = [dict(bench['configs'][-1], name='tiny', file='port_bench/configs/tiny.json')]
    bench['workloads'] = [dict(name='tiny-video', config='tiny', traffic='tiny', chips=1,
                               why='a tiny video cell for the CPU tests')]
    for m in bench['per_layer']:
        m['workloads'] = ['tiny-video']
    tiny.write(root / 'BENCHMARK.json', bench)
    tiny.write(root / 'port_bench' / 'configs' / 'tiny.json', tiny_video_config())
    tiny.write(root / 'port_bench' / 'traffic' / 'tiny.json',
               dict(registry.traffic('video-f16-b1'), tokens_min=2, tokens_max=6, check_from=2))
    tiny.write(root / 'port_bench' / 'cells' / 'tiny-video.json',
               dict(limits=dict(start=dict(limit=0.), answer=dict(limit=0.),
                                step_rms=dict(limit=1e-4))))
    for folder in ('metrics', 'systems'):
        shutil.copytree(tiny.REAL / folder, root / 'port_bench' / folder,
                        ignore=shutil.ignore_patterns('__pycache__'))
    return root


def result_of(capsys, root, trace=0):
    code = runner.run(['--workload', 'tiny-video', '--seed', str(SEED), '--seconds', '0.2',
                       '--trace', str(trace)], root=root, device=torch.device('cpu'))
    out, err = capsys.readouterr()
    assert code == 0, err
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize('cell', sorted(CELLS))
def test_the_new_cells_files_parse(cell):
    config, traffic = CELLS[cell]
    entry = registry.workload(cell)
    assert (entry['config'], entry['traffic'], entry['chips']) == (config, traffic, 1)
    limits = registry.cell(cell)['limits']
    assert limits['start']['limit'] == limits['answer']['limit'] == 0.
    assert limits['step_rms']['lower'] < limits['step_rms']['limit'] < limits['step_rms']['upper']
    assert registry.traffic(traffic)['prompts'] == 1
    names = {m['name'] for m in registry.per_layer(cell)}
    assert set(READERS) <= names or cell != 'video64-serve-f16'
    assert {'attn_roofline', 'conv3x3_roofline', 'step_mfu', 'device.peak_gib'} <= names


def test_the_video_configuration_is_the_reference_s():
    from port_bench import flops_video
    config = registry.config('unet3d-64-f16')
    entry = next(c for c in registry.benchmark()['configs'] if c['name'] == 'unet3d-64-f16')
    assert entry['reduced'] == list(config['reduced_from']) == ['timesteps']
    assert config['unets'][0]['dim'] == 512 and config['frames'] == 16
    assert list(flops_video.count(config)) == config['flops_per_row'] + config['params']


def test_a_tiny_video_run_is_correct(tmp_path, capsys):
    result = result_of(capsys, make_video_root(tmp_path))
    assert result['correct'] is True and result['failed'] == 0
    assert result['checks']['step_rms']['value'] < 1e-5
    assert set(result['metrics']) == {'images_per_s', 'setup_s'}


def _perturbed_step(inner):
    """The second step of each request comes out moved by 0.01."""
    def p_sample(self, unet, x, t, **kwargs):
        out, x_start = inner(self, unet, x, t, **kwargs)
        self.calls = getattr(self, 'calls', 0) + 1
        return (out + 0.01 if self.calls % 3 == 2 else out), x_start
    return p_sample


def test_a_perturbed_step_is_not_correct(tmp_path, capsys, monkeypatch):
    from imagen_tpu_torch import Imagen
    monkeypatch.setattr(Imagen, 'p_sample', _perturbed_step(Imagen.p_sample))
    result = result_of(capsys, make_video_root(tmp_path))
    assert result['correct'] is False
    assert result['checks']['step_rms']['value'] == pytest.approx(0.01, rel=1e-3)


def test_a_traced_tiny_video_run_reads_the_temporal_counter(tmp_path, capsys):
    result = result_of(capsys, make_video_root(tmp_path), trace=1)
    assert result['correct'] is True
    # the CPU takes the temporal kernel's plain version, on the kernel route
    assert result['metrics']['temporal_attn.kernel_share']['value'] == 100.
    # the CPU has no device trace: the device readers find nothing and are left out
    assert 'video.temporal_ms' not in result['metrics']
    assert 'temporal_attn_roofline' not in result['metrics']


def test_the_temporal_readers_on_a_synthetic_trace(tmp_path):
    """Two temporal sites and a conv site in a request of 1000 us, and a
    recording that holds the program's `video.temporal` spans."""
    from imagen_tpu_torch.utils import profiling
    events = [span('pb.slice', 0, 1000), span('pb.request', 0, 990),
              span('pb.site.video.temporal_ms:0', 20, 50),
              span('pb.site.video.temporal_ms:1', 100, 50),
              span('pb.site.temporal_attn_roofline:0', 100, 50)]
    events += [launch(c, t) for c, t in ((1, 25), (2, 110), (3, 300))]
    events += [kernel(1, 100, 100), kernel(2, 200, 40, name='temporal_attn_fwd_kernel'),
               kernel(3, 400, 300)]
    path = tmp_path / 'trace.json'
    path.write_text(json.dumps(dict(traceEvents=events)))
    record = Record({}, {}, trace=Trace.load(path), slice_requests=1)
    record.sites = {'temporal_attn_roofline': [(989e12 * 10e-6, 0)]}
    readers = {name: registry.metric(name) for name in READERS}
    with profiling.span('video.temporal'), profiling.span('unet.forward'):
        profiling.count('temporal_attention', 'kernel', (8, 4, 2, 5, 8), 3)
        profiling.count('temporal_attention', 'plain', (8, 4, 2, 5, 8), 1)
    assert readers['video.temporal_ms'].read(record) == pytest.approx(0.14)
    assert readers['temporal_attn_roofline'].read(record) == pytest.approx(25.)
    assert readers['temporal_attn.kernel_share'].read(record) == pytest.approx(75.)
    assert profiling.active_recording() is None


def test_the_video_reference_loads_nothing_of_the_program():
    from port_bench.tests.test_port_bench_imports import FORBIDDEN, loaded_after
    names = loaded_after('from port_bench.reference import unet3d, video\n'
                         'from port_bench import flops_video, weights\n')
    assert 'torch' in names
    assert not names & (FORBIDDEN | {'imagen_tpu_torch'})
