"""The port's configs, unet persistence and command line against the JAX
package's, on the CPU.

- `model_dump()` of the port's configs equals the JAX
  package's pydantic dump for the same input: lists and tuples, coerced
  numbers, nested unet configs, extra keys, the trainer config;
- `create()` from the `imagen config` default (widths cut to dim 8; at full
  width on the meta device, the parameter count of each unet against the
  JAX one's), the JAX tests' video config and an elucidated config: the
  weights of the JAX package's models bridge into the port's with
  `strict=True`;
- `persist_unet_to_file` / `hydrate_unet_from_file` round trips (the class
  recorded) and a unet the JAX package persisted, read by the port;
- the `config` command writes the JAX command's JSON; `train` runs two
  steps from a config file with `datasets.load_dataset` and T5 stood in,
  and `sample` draws from the checkpoint it wrote;
- what the multi-device options still refuse: a layout without a process
  group, a mesh of another kind, an unknown checkpoint backend.
"""
import json
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from torch_port_bridge import TINY_T5, StandInEncoder, inject_t5, jparams, \
    random_params, rng, t

import imagen_tpu.configs as jconfigs
from imagen_tpu.cli import imagen as jcli
from imagen_tpu.utils import persist as jpersist

import imagen_tpu_torch as it
from imagen_tpu_torch import configs
from imagen_tpu_torch.cli import imagen as tcli
from imagen_tpu_torch.utils import persist
from imagen_tpu_torch.utils.checkpoint_io import load_obj, LocalFS
from imagen_tpu_torch.utils.port_weights import state_dict_from_jax

CPU = 'cpu'
DEFAULT = json.loads(open(it.__path__[0] + '/default_config.json').read())
TINY = dict(dim=8, dim_mults=[1, 2], text_embed_dim=16, cond_dim=8, attn_dim_head=4,
            attn_heads=2, attn_pool_num_latents=2, max_text_len=8, layer_attns=False,
            layer_cross_attns=[False, True])
# the JAX tests' video config (tests/test_runtime_extras.py::test_video_config_create)
VIDEO = dict(video=True, unets=[TINY], image_sizes=[8], timesteps=4, text_embed_dim=16)
ELUCIDATED = dict(unets=[TINY, {**TINY, 'layer_attns': [False, True]}], image_sizes=(8, 16),
                  text_embed_dim=16, num_sample_steps=(3, 2), sigma_max=80, rho=7,
                  cond_drop_prob=0.1)


def _cut(unet):
    """A default-config unet at dim 8 with its layer layout kept."""
    blocks = unet.get('num_resnet_blocks', 1)
    return {**unet, 'dim': 8, 'attn_heads': 2, 'attn_dim_head': 4, 'cond_dim': 8,
            'max_text_len': 8, 'attn_pool_num_latents': 2,
            'num_resnet_blocks': [min(n, 2) for n in blocks] if isinstance(blocks, list)
            else 1}


DEFAULT_CUT = {**DEFAULT['imagen'], 'unets': [_cut(u) for u in DEFAULT['imagen']['unets']],
               'image_sizes': [8, 16, 32], 'random_crop_sizes': [None, 8, 16],
               'text_embed_dim': 16}

DUMPS = {
    'default': (jconfigs.ImagenConfig, DEFAULT['imagen']),
    'video': (jconfigs.ImagenConfig, VIDEO),
    'elucidated': (jconfigs.ElucidatedImagenConfig, ELUCIDATED),
    'tuples_and_extras': (jconfigs.ImagenConfig, dict(
        unets=({'dim': '8', 'dim_mults': (1, 2), 'layer_attns': (False, True)},),
        image_sizes=(16,), timesteps=(4, 4), noise_schedules=('cosine',), cond_drop_prob=1,
        sigma=3)),
    'null_unet': (jconfigs.ImagenConfig, dict(unets=[{'is_null': True, 'dim': 3}, TINY],
                                              image_sizes=[8, 16], noise_schedules='linear')),
    'trainer': (jconfigs.ImagenTrainerConfig, dict(
        imagen=VIDEO, lr=(1e-4,), warmup_steps=(None, 3), max_grad_norm=1, beta1=0,
        optimizer='adafactor', checkpoint_every=2)),
    'one_tuples': (jconfigs.ElucidatedImagenConfig, dict(
        unets=({**TINY, 'dim_mults': (1, 2)},), image_sizes=(8,), rho=(7,), sigma_min=(1,),
        num_sample_steps=(True,), S_churn=[80])),
    'strict_one_tuple': (jconfigs.ImagenConfig, dict(unets=(TINY,), image_sizes=(8,),
                                                      timesteps=(4,))),
}


@pytest.mark.parametrize('name', sorted(DUMPS))
def test_model_dump_is_the_jax_dict(name):
    jklass, kwargs = DUMPS[name]
    klass = getattr(configs, jklass.__name__)
    mine, ref = klass(**kwargs).model_dump(), jklass(**kwargs).model_dump()
    assert mine == ref
    assert json.dumps(mine) == json.dumps(ref)   # the same types: lists, tuples, floats


@pytest.mark.parametrize('kwargs', [
    dict(unets=[TINY], image_sizes=[8, 16]),                      # check_image_sizes
    dict(unets=[TINY], image_sizes=[8], noise_schedules='square'),
    dict(unets=[{**TINY, 'dim': 8.5}], image_sizes=[8]),
    dict(unets=[{'dim_mults': [1]}], image_sizes=[8]),
    dict(image_sizes=[8]),
])
def test_invalid_configs_raise_in_both(kwargs):
    with pytest.raises(ValueError):
        jconfigs.ImagenConfig(**kwargs)
    with pytest.raises(ValueError):
        configs.ImagenConfig(**kwargs)


def _bridge(jimagen, timagen):
    """Seeded params for each JAX unet, loaded into the port's strictly."""
    checked = 0
    for i, (junet, tunet, size) in enumerate(zip(jimagen.unets, timagen.unets,
                                                  jimagen.image_sizes)):
        if isinstance(tunet, it.NullUnet):
            continue
        shape = (1, 2, size, size, 3) if jimagen.is_video else (1, size, size, 3)
        x, time = jnp.zeros(shape), jnp.zeros((1,))
        kw = dict(text_embeds=jnp.zeros((1, 8, jimagen.text_embed_dim)),
                  text_mask=jnp.ones((1, 8), bool))
        if junet.lowres_cond:
            kw.update(lowres_cond_img=x, lowres_noise_times=time)
        params = random_params(junet, x, time, **kw, seed=i)
        tunet.load_state_dict(state_dict_from_jax(params, video=jimagen.is_video), strict=True)
        checked += 1
    return checked


@pytest.mark.parametrize('name', ['default_cut', 'video', 'elucidated', 'trainer'])
def test_created_models_bridge_strictly(name):
    if name == 'trainer':
        kwargs = dict(imagen=VIDEO, use_ema=False, verbose=False)
        jimagen = jconfigs.ImagenTrainerConfig(**kwargs).create().imagen
        trainer = configs.ImagenTrainerConfig(**kwargs).create(device=CPU)
        assert isinstance(trainer, it.ImagenTrainer)
        timagen = trainer.imagen
    else:
        jklass, kwargs = {'default_cut': (jconfigs.ImagenConfig, DEFAULT_CUT),
                          'video': (jconfigs.ImagenConfig, VIDEO),
                          'elucidated': (jconfigs.ElucidatedImagenConfig, ELUCIDATED)}[name]
        jimagen = jklass(**kwargs).create()
        timagen = getattr(configs, jklass.__name__)(**kwargs).create(device=CPU)
    assert type(timagen).__name__ == type(jimagen).__name__
    assert [type(u).__name__ for u in timagen.unets] == [type(u).__name__ for u in jimagen.unets]
    assert timagen._config == jimagen._config
    assert _bridge(jimagen, timagen) == len(timagen.unets)


@pytest.fixture(scope='module')
def full_width():
    return (jconfigs.ImagenConfig(**DEFAULT['imagen']).create(),
            configs.ImagenConfig(**DEFAULT['imagen']).create(device='meta'))


@pytest.mark.parametrize('index', [0, 1, 2])
def test_default_config_at_full_width(full_width, index):
    """The shipped recipe's unets at their published widths: built on the meta
    device, each has the JAX unet's parameter count."""
    jimagen, timagen = full_width
    junet, size = jimagen.unets[index], jimagen.image_sizes[index]
    x, time = jnp.zeros((1, size, size, 3)), jnp.zeros((1,))
    kw = dict(text_embeds=jnp.zeros((1, 8, 1024)), text_mask=jnp.ones((1, 8), bool))
    if junet.lowres_cond:
        kw.update(lowres_cond_img=x, lowres_noise_times=time)
    shapes = jax.eval_shape(lambda: junet.init(jax.random.PRNGKey(0), x, time, **kw))
    expected = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in timagen.unets[index].parameters()) == expected


def test_persist_and_hydrate(tmp_path):
    torch.manual_seed(0)
    unet = it.Unet(**{k: tuple(v) if isinstance(v, list) else v for k, v in TINY.items()},
                   device=CPU).eval()
    path = tmp_path / 'nested' / 'unet.ckpt'
    persist.persist_unet_to_file(unet, path)
    again = persist.hydrate_unet_from_file(path, device=CPU).eval()
    assert type(again) is it.Unet and again._config == unet._config
    r = rng(1)
    x, time = t(r.rand(2, 16, 16, 3).astype(np.float32)), torch.tensor([0.2, 0.7])
    emb = t(r.randn(2, 8, 16).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(unet(x, time, text_embeds=emb), again(x, time, text_embeds=emb))

    video = it.Unet3D(**TINY, device=CPU)
    persist.persist_unet_to_file(video, tmp_path / 'video.ckpt')
    assert type(persist.hydrate_unet_from_file(tmp_path / 'video.ckpt', device=CPU)) is it.Unet3D
    persist.persist_unet_to_file(it.NullUnet(device=CPU), tmp_path / 'null.ckpt')
    assert type(persist.hydrate_unet_from_file(tmp_path / 'null.ckpt', device=CPU)) is it.NullUnet


def test_hydrate_a_unet_the_jax_package_persisted(tmp_path):
    from imagen_tpu.models.unet2d import Unet as JUnet
    junet = JUnet(**{k: tuple(v) if isinstance(v, list) else v for k, v in TINY.items()})
    x, time = jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,))
    params = random_params(junet, x, time, text_embeds=jnp.zeros((1, 8, 16)),
                           text_mask=jnp.ones((1, 8), bool), seed=4)
    path = str(tmp_path / 'jax_unet.ckpt')
    jpersist.persist_unet_to_file(junet, jparams(params), path)
    unet = persist.hydrate_unet_from_file(path, device=CPU)
    assert type(unet) is it.Unet and unet.dtype == torch.float32
    expected = state_dict_from_jax(params)
    for k, v in unet.state_dict().items():
        assert torch.equal(v, expected[k]), k
    raw = load_obj(LocalFS(), path)   # the flax msgpack, decoded without flax
    assert raw['unet_class'] == 'Unet' and raw['config']['dim'] == 8


def test_config_command_writes_the_jax_json(tmp_path):
    runner = CliRunner()
    for cli, name in ((tcli, 'port.json'), (jcli, 'jax.json')):
        result = runner.invoke(cli, ['config', '--path', str(tmp_path / name)])
        assert result.exit_code == 0, result.output
    assert (tmp_path / 'port.json').read_bytes() == (tmp_path / 'jax.json').read_bytes()
    data = json.loads((tmp_path / 'port.json').read_text())
    assert data['type'] == 'original' and len(data['imagen']['unets']) == 3


def test_train_command_runs_two_steps(tmp_path, monkeypatch):
    """Then `sample` draws from the checkpoint `train` wrote."""
    r = rng(3)
    rows = [dict(image=Image.fromarray((r.rand(20, 18, 3) * 255).astype(np.uint8)),
                 caption=f'picture number {i}') for i in range(4)]
    loaded = []

    def load_dataset(name):
        loaded.append(name)
        return {'train': rows}

    monkeypatch.setitem(sys.modules, 'datasets', SimpleNamespace(load_dataset=load_dataset))
    inject_t5(monkeypatch, StandInEncoder(16))
    ckpt = tmp_path / 'imagen.ckpt'
    cfg = dict(type='original',
               imagen=dict(unets=[TINY], image_sizes=[16], timesteps=4,
                           text_encoder_name=TINY_T5, cond_drop_prob=0.1),
               trainer=dict(lr=1e-3, verbose=False),
               dataset_name='a/dataset', dataset=dict(batch_size=2, shuffle=False),
               image_label='image', url_label=None, text_label='caption',
               checkpoint_path=str(ckpt))
    (tmp_path / 'cfg.json').write_text(json.dumps(cfg))
    result = CliRunner().invoke(tcli, ['train', '--config', str(tmp_path / 'cfg.json'),
                                       '--unet', '1', '--epoches', '1', '--device', CPU])
    assert result.exit_code == 0, (result.output, result.exception)
    assert loaded == ['a/dataset']
    bundle = torch.load(ckpt, weights_only=False)
    assert bundle['steps'].tolist() == [2] and bundle['imagen_type'] == 'original'
    imagen = it.load_imagen_from_checkpoint(str(ckpt), device=CPU)
    assert imagen.text_encoder_name == TINY_T5 and imagen.text_embed_dim == 16

    monkeypatch.chdir(tmp_path)           # `sample` writes ./<prompt>.png
    result = CliRunner().invoke(tcli, ['sample', '--model', str(ckpt), '--device', CPU,
                                       '--cond_scale', '2', 'a red fox'])
    assert result.exit_code == 0, (result.output, result.exception)
    with Image.open(tmp_path / 'a_red_fox.png') as image:
        assert image.size == (16, 16)


def test_multi_device_options_raise():
    """What still raises: a `parallel` block or mesh without a process group
    to lay out, a mesh that is not a ('data', 'model') DeviceMesh and an
    unknown checkpoint backend. Without a mesh `fsdp` and ZeRO-1 cut
    nothing, as in the JAX trainer."""
    assert configs.apply_parallel({'lr': 1e-4, 'parallel': None}) == {'lr': 1e-4}
    with pytest.raises(RuntimeError, match='needs a process group'):
        configs.apply_parallel({'parallel': {'data': 8}}, device=CPU)
    with pytest.raises(RuntimeError, match='needs a process group'):
        configs.ImagenTrainerConfig(imagen=VIDEO, parallel={'data': 8, 'fsdp': True}).create(
            device=CPU)
    imagen = configs.ImagenConfig(**VIDEO).create(device=CPU)
    with pytest.raises(TypeError, match='DeviceMesh'):
        it.ImagenTrainer(imagen, mesh=object())
    with pytest.raises(ValueError, match='unknown checkpoint_backend'):
        it.ImagenTrainer(imagen, checkpoint_backend='tensorstore')
    trainer = it.ImagenTrainer(imagen, fsdp=True, shard_optimizer_states=64, verbose=False)
    assert not trainer._fsdp_enabled() and not trainer._zero_enabled()
