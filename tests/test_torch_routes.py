"""Where each kernel's route is decided: the entries under `imagen_tpu_torch/ops/`.

- One `setattr` on the `ops` module that defines a gate closes it for every
  site of a tiny `Unet` or `Unet3D` forward: each site then takes its plain
  route, as the route counter (`conv3x3`, `attention`,
  `temporal_attention`) or, for an operation without one, a spy on its
  kernel function sees, and the output stays that of the open gate.
- No module under `imagen_tpu_torch/models/` imports a gate (a name ending
  in `_available`) or `wants_grad`: the models call one entry per
  operation and know no gate.

CPU only, no JAX: on the CPU each kernel function runs its plain version.
"""
import ast
import functools
from pathlib import Path

import pytest
import torch

import imagen_tpu_torch as it
from imagen_tpu_torch.ops import conv2d, flash_attention, fused_norm, stem_conv, temporal_layout
from imagen_tpu_torch.utils.profiling import recording

MODELS = Path(__file__).resolve().parents[1] / 'imagen_tpu_torch' / 'models'
COND = dict(text_embed_dim=16, cond_dim=32, max_text_len=8, attn_pool_num_latents=2,
            device='cpu')
# (config, input shape): the 128^2 maps of 128 channels the conv gate admits;
# a 32^2 level of 128 channels with attention over its 1024 tokens, FiLM fused
# and the cross-embed stem; a 4-frame video whose middle attends over
# 4 x 16^2 tokens and whose 128-channel temporal sites the fold gate admits
NETS = {
    'unet128': (it.Unet, dict(dim=128, dim_mults=(1,), num_resnet_blocks=1, layer_attns=False,
                              layer_cross_attns=False, attend_at_middle=False, **COND),
                (1, 128, 128, 3)),
    'unet32': (it.Unet, dict(dim=128, dim_mults=(1,), num_resnet_blocks=1, layer_attns=True,
                             layer_cross_attns=False, attn_heads=2, attn_dim_head=64,
                             fused_film=True, **COND), (1, 32, 32, 3)),
    'unet3d': (it.Unet3D, dict(dim=16, dim_mults=(1, 8), layer_attns=False,
                               layer_cross_attns=False, attn_heads=2, attn_dim_head=8,
                               temporal_fused_ln=True, **COND), (1, 4, 32, 32, 3)),
}


# gate, its defining module, the net, and what sees its kernel route
CASES = [
    ('conv2d_same_available', conv2d, 'unet128', ('counter', 'conv3x3', 'kernel')),
    ('fused_feedforward_available', fused_norm, 'unet32', ('spy', fused_norm,
                                                           'fused_feedforward')),
    ('fused_film_available', fused_norm, 'unet32', ('spy', fused_norm, 'fused_film_norm')),
    ('stem_available', stem_conv, 'unet32', ('spy', stem_conv, 'cross_embed_stem')),
    ('flash_attention_available', flash_attention, 'unet32', ('counter', 'attention', 'flash')),
    ('flash_attention_available', flash_attention, 'unet3d', ('counter', 'attention', 'flash')),
    ('grouped_temporal_available', flash_attention, 'unet3d',
     ('counter', 'temporal_attention', 'kernel')),
    ('temporal_layout_available', temporal_layout, 'unet3d', ('spy', temporal_layout,
                                                              'fused_ln_transpose')),
]


@functools.lru_cache(maxsize=None)
def net(name):
    cls, cfg, shape = NETS[name]
    torch.manual_seed(0)
    unet = cls(**cfg).eval()
    g = torch.Generator().manual_seed(1)
    args = (torch.randn(shape, generator=g), torch.rand(shape[0], generator=g))
    return unet, args, dict(text_embeds=torch.randn(shape[0], 8, 16, generator=g))


def kernel_calls(monkeypatch, seen, name):
    """One forward of net `name`: its output and the calls on the kernel route."""
    unet, args, kwargs = net(name)
    if seen[0] == 'counter':
        with recording() as rec, torch.no_grad():
            out = unet(*args, **kwargs)
        return out, rec.routes(seen[1]).get(seen[2], [0])[0]
    _, module, fn = seen
    calls = []
    kernel = getattr(module, fn)

    def counted(*a, **k):
        calls.append(1)
        return kernel(*a, **k)
    with monkeypatch.context() as m, torch.no_grad():
        m.setattr(module, fn, counted)
        out = unet(*args, **kwargs)
    return out, len(calls)


@pytest.mark.parametrize('gate, module, name, seen', CASES,
                         ids=[f'{c[0]}-{c[2]}' for c in CASES])
def test_one_patch_sends_every_site_to_the_plain_route(gate, module, name, seen, monkeypatch):
    out, on_kernel = kernel_calls(monkeypatch, seen, name)
    assert on_kernel > 0
    monkeypatch.setattr(module, gate, lambda *a, **k: False)
    plain, still = kernel_calls(monkeypatch, seen, name)
    assert still == 0
    torch.testing.assert_close(plain, out, rtol=1e-4, atol=1e-4 * float(out.abs().max()))


def test_models_import_no_gate():
    found = []
    for path in sorted(MODELS.glob('*.py')):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom):
                found += [(path.name, a.name) for a in node.names
                          if a.name.endswith('_available') or a.name == 'wants_grad']
    assert found == []
