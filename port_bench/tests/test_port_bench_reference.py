"""The frozen reference held to `imagen_tpu_torch` at a tiny size on the CPU
with shared weights, and the stored operation counts recomputed."""
from __future__ import annotations

import copy

import pytest
import torch

from port_bench import correctness, flops, reference, registry, traffic
from port_bench.systems import imagen_sample as drv
from port_bench.tests import tiny

SEED = 2 ** 31 + 5


CASES = tiny.KINDS


@pytest.mark.parametrize('case', sorted(CASES))
def test_the_reference_follows_the_program_sampler(case):
    """The program in float32 through its own entry; the reference follows
    its states to rounding."""
    config, mix = CASES[case][0](), CASES[case][1]()
    cpu = torch.device('cpu')
    system = drv.build(config, mix, cpu)
    drv.load_weights(system, SEED, cpu)
    refs = drv.reference_unets(config, SEED, cpu)
    request = traffic.request(mix, config, SEED, 0, cpu)
    states = []
    served = drv.serve(system, request, states)
    assert len(states) == len(config['unets']) - mix['start_at_unet_number'] + 1
    found = correctness.numbers(served, drv.follow(refs, config, mix, request, states))
    assert found['start'] == 0. and found['answer'] == 0.
    assert found['step_rms'] < 1e-5


@pytest.mark.parametrize('case', sorted(CASES))
def test_a_forward_matches_at_the_same_inputs(case):
    config = CASES[case][0]()
    cpu = torch.device('cpu')
    system = drv.build(config, CASES[case][1](), cpu)
    drv.load_weights(system, SEED, cpu)
    refs = drv.reference_unets(config, SEED, cpu)
    gen = torch.Generator().manual_seed(1)
    for index, (unet, ref) in enumerate(zip(system.imagen.unets, refs)):
        if ref is None:
            continue
        size = config['image_sizes'][index]
        x = torch.randn((2, size, size, 3), generator=gen)
        time = torch.randn(2, generator=gen) * 5
        kwargs = dict(text_embeds=torch.randn((2, 5, config['text_embed_dim']), generator=gen),
                      text_mask=torch.tensor([[1, 1, 0, 0, 0], [1, 1, 1, 1, 1]]).bool())
        if index > 0:
            kwargs.update(lowres_cond_img=torch.randn((2, size, size, 3), generator=gen),
                          lowres_noise_times=torch.randn((2,), generator=gen))
        drop = torch.tensor([False, True])
        with torch.no_grad():
            ours = ref(x, time, drop_text=drop, **kwargs)
            theirs = unet(x, time, force_text_drop_mask=drop, **kwargs)
        assert (ours - theirs).abs().max() < 1e-4 * max(1., ours.abs().max().item())


def test_every_parameter_is_seeded_away_from_zero():
    config = tiny.tiny_config()
    made = drv.weights_of(SEED, torch.device('cpu'))
    refs = drv.reference_unets(config, SEED, torch.device('cpu'))
    for index, ref in enumerate(refs):
        for name, tensor in made(index, reference.specs(config, index)).items():
            assert tensor.abs().max() > 0, name
            assert torch.equal(tensor, ref.state_dict()[name]), name


@pytest.mark.parametrize('name', ['imagen-64-256', 'imagen-sr1024'])
def test_the_stored_counts_are_the_reference_counts(name):
    config = registry.config(name)
    assert list(flops.count(config)) == [config['flops_per_row'], config['params']]


def test_the_control_computes_below_the_stated_precision():
    """The control (the reference in float8, one step below the bf16 the
    configurations state) in the program's place fails the cells' limit."""
    config = copy.deepcopy(tiny.tiny_config())
    mix = tiny.tiny_mix()
    cpu = torch.device('cpu')
    refs = drv.reference_unets(config, SEED, cpu)
    request = traffic.request(mix, config, SEED, 0, cpu)
    served, states = drv.control(refs, config, mix, request)
    found = correctness.numbers(served, drv.follow(refs, config, mix, request, states))
    assert found['start'] == 0. and found['answer'] == 0.
    serving = [registry.cell(cell['name'])['limits'] for cell in registry.benchmark()['workloads']
               if registry.traffic(cell['traffic'])['system'] == 'imagen_sample']
    assert serving
    for limits in serving:
        assert found['step_rms'] > limits['step_rms']['limit']
