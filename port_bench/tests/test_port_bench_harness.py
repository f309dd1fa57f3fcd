"""The harness on the CPU at a tiny size: discovery by name, a run's result,
the run that finds no card, and the planted faults that `correct` catches."""
from __future__ import annotations

import json

import pytest
import torch

from port_bench import registry, run as runner
from port_bench.tests import tiny

ARGS = ['--workload', 'tiny-serve', '--seed', str(2 ** 31 + 11), '--seconds', '0.2']


def result_of(capsys, root, trace=0):
    code = runner.run(ARGS + ['--trace', str(trace)], root=root, device=torch.device('cpu'))
    out, err = capsys.readouterr()
    assert code == 0, err
    return json.loads(out.strip().splitlines()[-1]), err


def test_new_files_are_found_by_name(tmp_path):
    root = tiny.make_root(tmp_path)
    assert registry.workload('tiny-serve', root)['config'] == 'tiny'
    assert registry.config('tiny', root)['image_sizes'] == [16, 32]
    assert registry.traffic('tiny', root)['prompts'] == 2
    (root / 'port_bench' / 'metrics' / 'extra.count.py').write_text(
        'def read(run):\n    return 7.\n')
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['per_layer'].append(dict(name='extra.count', unit='n', better='lower',
                                   source='program_counter', layer='request',
                                   moves='images_per_s'))
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    names = [m['name'] for m in registry.per_layer('tiny-serve', root)]
    assert 'extra.count' in names
    assert registry.metric('extra.count', root).read(None) == 7.


def test_every_benchmark_entry_has_its_files():
    bench = registry.benchmark()
    for cell in bench['workloads']:
        config = registry.config(cell['config'])
        mix = registry.traffic(cell['traffic'])
        assert registry.cell(cell['name'])['limits']
        assert (registry.ROOT / 'port_bench' / 'systems' / f'{mix["system"]}.py').exists()
        assert len(config['flops_per_row']) == len(config['unets'])
    for m in bench['per_layer']:
        assert hasattr(registry.metric(m['name']), 'read')


def test_a_run_without_a_card_fails_and_prints_nothing(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    code = runner.run(['--workload', 'cascade256-serve-b8', '--seed', '1', '--seconds', '1',
                       '--trace', '0'])
    out, err = capsys.readouterr()
    assert code != 0
    assert out == ''
    assert 'CUDA' in err


def test_a_tiny_run_is_correct_and_prints_its_checks_last(tmp_path, capsys):
    root = tiny.make_root(tmp_path)
    result, err = result_of(capsys, root)
    assert result['correct'] is True
    assert result['failed'] == 0 and result['attempted'] >= 1
    assert set(result['metrics']) == {'images_per_s', 'setup_s'}
    assert list(result)[-1] == 'checks'
    assert set(result['checks']) == {'start', 'answer', 'step_rms'}
    assert err.strip().splitlines()[-1].startswith('check ')


def test_a_traced_tiny_run_reports_the_host_metrics(tmp_path, capsys):
    root = tiny.make_root(tmp_path)
    result, _ = result_of(capsys, root, trace=1)
    assert result['correct'] is True
    # the CPU has no device trace: the device readers find nothing and are left out
    assert 'request.p90_s' in result['metrics'] and 'step_mfu' in result['metrics']
    assert 'conv3x3_roofline' not in result['metrics']
    assert not (root / 'build' / 'port_bench' / 'trace.json').exists()


def _unchanged_step(self, unet, x, t, **kwargs):
    return x, x


def _half_batch(inner):
    def p_sample(self, unet, x, t, **kwargs):
        out, x_start = inner(self, unet, x, t, **kwargs)
        half = out.shape[0] // 2
        kept = out[:half]
        return torch.cat((kept, kept.mean(0, keepdim=True).expand(out.shape[0] - half,
                                                                   *out.shape[1:]))), x_start
    return p_sample


def _altered_answer(inner):
    def answer(self, **kwargs):
        images = inner(self, **kwargs)
        images[0, 0, 0, 0] = 1. - images[0, 0, 0, 0]
        return images
    return answer


# each fault the cell can have; one card and no exchange between cards, and a
# batch of one prompt has no half to leave out
FAULTS = [('cascade', 'unchanged_step'), ('cascade', 'half_batch'),
          ('cascade', 'altered_answer'), ('sr', 'unchanged_step'), ('sr', 'altered_answer')]


@pytest.mark.parametrize('kind,fault', FAULTS)
def test_a_planted_fault_is_not_correct(tmp_path, capsys, monkeypatch, kind, fault):
    from imagen_tpu_torch import Imagen, ImagenServer
    if fault == 'unchanged_step':
        monkeypatch.setattr(Imagen, 'p_sample', _unchanged_step)
    elif fault == 'half_batch':
        monkeypatch.setattr(Imagen, 'p_sample', _half_batch(Imagen.p_sample))
    elif kind == 'cascade':
        monkeypatch.setattr(ImagenServer, 'generate', _altered_answer(ImagenServer.generate))
    else:
        monkeypatch.setattr(Imagen, 'sample', _altered_answer(Imagen.sample))
    result, _ = result_of(capsys, tiny.make_root(tmp_path, kind=kind))
    assert result['correct'] is False


@pytest.mark.parametrize('kind', sorted(tiny.KINDS))
def test_a_sound_tiny_run_of_each_kind_is_correct(tmp_path, capsys, kind):
    result, _ = result_of(capsys, tiny.make_root(tmp_path, kind=kind))
    assert result['correct'] is True
    assert result['checks']['step_rms']['value'] < 1e-5


# each tiny serving kind's checks at ARGS's seed, as the harness before the
# training cell's adapter interface printed them (CPU, float32)
BEFORE = {'cascade': dict(start=0.0, answer=0.0, step_rms=2.4841500165068135e-06),
          'sr': dict(start=0.0, answer=0.0, step_rms=5.664703915540376e-07)}


@pytest.mark.parametrize('kind', sorted(BEFORE))
def test_a_tiny_serving_run_checks_as_before(tmp_path, capsys, kind):
    result, _ = result_of(capsys, tiny.make_root(tmp_path, kind=kind))
    assert result['correct'] is True
    assert {k: v['value'] for k, v in result['checks'].items()} == BEFORE[kind]
