"""The training cell's harness on the CPU at a tiny size: a run's result, the
program's step against the reference's in float32, the float8 control, and
the planted faults that `correct` catches.

The tiny U-Net's tensors are smaller than Adafactor's factoring threshold
(two dims of at least 128), so each test lowers it to 8 on both sides and
the factored second moments are exercised too.
"""
from __future__ import annotations

import json

import pytest
import torch

from port_bench import registry, run as runner, traffic
from port_bench.reference import numerics
from port_bench.tests import tiny

SEED = 2 ** 31 + 17
ARGS = ['--workload', 'tiny-train', '--seed', str(SEED), '--seconds', '0.2']
CPU = torch.device('cpu')


@pytest.fixture(autouse=True)
def factor_small_tensors(monkeypatch):
    import imagen_tpu_torch.optim as optim
    from port_bench.reference import train
    monkeypatch.setattr(optim, 'MIN_DIM_SIZE_TO_FACTOR', 8)
    monkeypatch.setattr(train, 'MIN_DIM_SIZE_TO_FACTOR', 8)


def result_of(capsys, root, trace=0):
    code = runner.run(ARGS + ['--trace', str(trace)], root=root, device=CPU)
    out, err = capsys.readouterr()
    assert code == 0, err
    return json.loads(out.strip().splitlines()[-1]), err


def test_a_tiny_training_run_is_correct_with_every_number(tmp_path, capsys):
    result, err = result_of(capsys, tiny.make_train_root(tmp_path))
    assert result['correct'] is True
    assert result['failed'] == 0 and result['attempted'] >= 1
    assert set(result['metrics']) == {'images_per_s', 'setup_s'}
    assert set(result['checks']) == set(tiny.TRAIN_LIMITS)
    assert result['checks']['draws']['value'] == 0.
    assert list(result)[-1] == 'checks'
    assert err.strip().splitlines()[-1].startswith('check ')


def test_a_traced_tiny_training_run_reports_the_whole_step(tmp_path, capsys):
    result, _ = result_of(capsys, tiny.make_train_root(tmp_path), trace=1)
    assert result['correct'] is True
    assert result['metrics']['train.step_mfu']['value'] > 0.
    # the CPU has no device trace: the span readers find nothing and are left out
    for name in ('train.backward_ms', 'train.optimizer_ms', 'train.ema_ms', 'conv3x3_roofline'):
        assert name not in result['metrics']
    # the program's own spans and counters fire in the training forward too
    for name in ('unet.host_ms_per_fwd', 'conv3x3.kernel_share', 'attn.flash_share'):
        assert result['metrics'][name]['value'] >= 0.


def readings(seed, **follow):
    """(the system, the program's readings, the reference's) of the tiny
    cell's first steps and of a late step after one more."""
    config, mix = tiny.tiny_config(), tiny.tiny_train_mix()
    drv = registry.system('imagen_train')
    system = drv.build(config, mix, CPU)
    drv.load_weights(system, seed, CPU)

    def request_of(i):
        return traffic.request(mix, config, seed, i, CPU)

    drv.warm_up(system, request_of)
    drv.serve(system, request_of(0))
    drv.settle(system, request_of, 1)
    found = drv.findings(system, [], {})
    return drv, request_of, found, drv.reference(config, mix, seed, CPU, request_of, found)


@pytest.mark.parametrize('seed', [3, SEED])
def test_the_program_and_the_reference_agree_in_float32(seed):
    drv, _, found, theirs = readings(seed)
    found = drv.numbers(found, theirs)
    assert found['draws'] == 0.
    assert found['loss'] < 1e-6 and found['late_loss'] < 1e-6
    assert found['grad'] < 1e-4 and found['late_grad_median'] < 1e-4
    assert found['change'] < tiny.TRAIN_LIMITS['change']
    assert found['late_change'] < tiny.TRAIN_LIMITS['late_change']
    assert found['ema'] < 1e-6


def test_the_late_step_follows_the_state_the_window_left():
    """The late step starts where the trainer was, and its EMA update is due."""
    drv, _, found, theirs = readings(SEED)
    mix = tiny.tiny_train_mix()
    start = found['late']['start']
    assert start['step'] + 1 == drv.ema_due(mix, mix['checked_steps'] + 1)
    assert start['optimizer'] and all(s['step'] == start['step']
                                      for s in start['optimizer'].values())
    assert theirs['late']['ema_unchanged'] > tiny.TRAIN_LIMITS['ema']


def test_the_control_computes_below_the_stated_precision():
    """The control (the reference in float8, one step below the bf16 the
    configuration states) in the program's place fails the late step's
    limits."""
    drv, request_of, found, theirs = readings(SEED)
    config, mix = tiny.tiny_config(), tiny.tiny_train_mix()
    n, late = mix['checked_steps'], found['late']
    with numerics.precision('fp8'):
        fp8 = dict(first=drv.follow(config, mix, SEED, CPU, [request_of(k - n) for k in range(n)]),
                   late=drv.follow_late(config, mix, CPU, late['start'], request_of(late['at'])))
    found = drv.numbers(fp8, theirs)
    limits = {k: v['limit'] for k, v in registry.cell('base64-train-b32')['limits'].items()}
    assert found['draws'] == 0.
    assert any(found[k] > limits[k] for k in ('late_loss', 'late_grad_median', 'late_change'))


def _restore_params(inner):
    """A step that advances the optimiser's state and leaves the weights as they were."""
    def step(self, *args, **kwargs):
        kept = [p.detach().clone() for g in self.param_groups for p in g['params']]
        inner(self, *args, **kwargs)
        with torch.no_grad():
            for p, k in zip((p for g in self.param_groups for p in g['params']), kept):
                p.copy_(k)
    return step


def _frozen_after_warm_up(inner):
    """Steps as it should through set-up's checked steps, then leaves the
    weights as they were."""
    checked = tiny.tiny_train_mix()['checked_steps']

    def step(self, *args, **kwargs):
        state = self.state[self.param_groups[0]['params'][0]]
        if not state or state['step'] < checked:
            return inner(self, *args, **kwargs)
        return _restore_params(inner)(self, *args, **kwargs)
    return step


def _halve_gradients(inner):
    """The backward accumulates half of each gradient."""
    def backward(self, index, batch, max_batch_size, scale=1.):
        return inner(self, index, batch, max_batch_size, scale=0.5 * scale)
    return backward


def _half_batch(inner):
    """The U-Net's output: the second half of the rows detached and the
    first half's gradient doubled, so the step follows the first half's mean."""
    def forward(self, x, *args, **kwargs):
        out = inner(self, x, *args, **kwargs)
        h = out.shape[0] // 2
        kept = out[:h]
        return torch.cat((kept + (kept - kept.detach()), out[h:].detach()))
    return forward


def _zero_noise(inner):
    def p_losses(self, unet, x_start, times, **kwargs):
        kwargs['noise'] = torch.zeros_like(x_start)
        return inner(self, unet, x_start, times, **kwargs)
    return p_losses


# each fault the cell can have (one card, so no exchange between cards), and
# a number it fails
FAULTS = [('unchanged_step', 'change'), ('frozen_after_warm_up', 'late_change'),
          ('halved_gradient', 'late_grad_median'), ('half_batch', 'late_change'),
          ('skipped_ema', 'ema'), ('zeroed_noise', 'draws'),
          ('unfactored_second_moment', 'late_loss')]


@pytest.mark.parametrize('fault,number', FAULTS)
def test_a_planted_fault_is_not_correct(tmp_path, capsys, monkeypatch, fault, number):
    import imagen_tpu_torch.optim as optim
    import imagen_tpu_torch.trainer as trainer
    from imagen_tpu_torch import Imagen
    from imagen_tpu_torch.models.unet2d import Unet
    if fault == 'unchanged_step':
        monkeypatch.setattr(optim.Adafactor, 'step', _restore_params(optim.Adafactor.step))
    elif fault == 'frozen_after_warm_up':
        monkeypatch.setattr(optim.Adafactor, 'step', _frozen_after_warm_up(optim.Adafactor.step))
    elif fault == 'halved_gradient':
        monkeypatch.setattr(trainer.ImagenTrainer, '_backward',
                            _halve_gradients(trainer.ImagenTrainer._backward))
    elif fault == 'half_batch':
        monkeypatch.setattr(Unet, 'forward', _half_batch(Unet.forward))
    elif fault == 'skipped_ema':
        monkeypatch.setattr(trainer, 'ema_update', lambda *args, **kwargs: None)
    elif fault == 'zeroed_noise':
        monkeypatch.setattr(Imagen, 'p_losses', _zero_noise(Imagen.p_losses))
    else:
        monkeypatch.setattr(optim, 'factored_dims', lambda shape: None)
    result, _ = result_of(capsys, tiny.make_train_root(tmp_path))
    assert result['correct'] is False
    check = result['checks'][number]
    assert check['value'] > check['limit']
