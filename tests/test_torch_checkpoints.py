"""The port's checkpoints on the CPU: folders, async saves, self-describing
bundles, and bundles that the JAX package's trainer wrote.

- A trainer with `checkpoint_path` / `checkpoint_every` writes
  `checkpoint.{steps}.ckpt` after optimiser steps (`step_with_batch` and
  `update`), keeps the newest `max_checkpoints_keep`, and a second trainer
  built alike resumes from the newest one: the same step counts, unet and EMA
  weights and optimiser state, bit for bit (Adam, and Adafactor with its bf16
  momentum), and the same next step.
- `save(async_save=True)` writes the state as it was when called, while
  training goes on; a failed write raises at the next save or load.
- `ImagenTrainer(imagen_checkpoint_path=...)` and
  `load_imagen_from_checkpoint` rebuild the cascade from the bundle alone.
- A bundle written by the JAX trainer (flax msgpack) for a NullUnet + SR
  cascade: `load_imagen_from_checkpoint(..., load_ema_if_available=True)`
  and `ImagenServer.from_checkpoint` serve its EMA weights, and their
  samples under the same noise equal JAX's to 1e-2 (fp32); the port's
  trainer takes its weights with `only_model=True` and refuses a full load.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_bridge import SR_CFG, jparams, max_abs, randn, random_params, rng, t

from imagen_tpu.configs import ImagenConfig as JImagenConfig
from imagen_tpu.trainer import ImagenTrainer as JTrainer

import imagen_tpu_torch as it
from imagen_tpu_torch.utils.checkpoint_io import LocalFS
from imagen_tpu_torch.utils.port_weights import state_dict_from_jax

CPU = 'cpu'
TINY = dict(dim=8, dim_mults=[1, 2], text_embed_dim=16, cond_dim=8, attn_dim_head=4,
            attn_heads=2, attn_pool_num_latents=2, max_text_len=8, layer_attns=False,
            layer_cross_attns=[False, True])
IMAGEN = dict(unets=[TINY], image_sizes=[16], timesteps=4, text_embed_dim=16,
              cond_drop_prob=0.1)


def _trainer(seed=0, **kwargs):
    torch.manual_seed(seed)
    kwargs = {'lr': 1e-3, 'ema_update_after_step': 0, 'ema_update_every': 1,
              'verbose': False, **kwargs}
    return it.ImagenTrainerConfig(imagen=IMAGEN, **kwargs).create(device=CPU)


def _batch(b, seed=0):
    r = rng(seed)
    return dict(images=t(r.rand(b, 16, 16, 3).astype(np.float32)),
                text_embeds=t(randn(r, b, 6, 16)))


def _assert_same_state(a, b):
    assert np.array_equal(a.steps, b.steps)
    for ua, ub in zip(a.unets, b.unets):
        for (k, x), y in zip(ua.state_dict().items(), ub.state_dict().values()):
            assert torch.equal(x, y), k
    for ea, eb in zip(a.ema_unets, b.ema_unets):
        for x, y in zip(ea.state_dict().values(), eb.state_dict().values()):
            assert torch.equal(x, y)
    for oa, ob in zip(a.optimizers, b.optimizers):
        sa, sb = oa.state_dict()['state'], ob.state_dict()['state']
        assert sa.keys() == sb.keys() and sa
        for k in sa:
            for name, v in sa[k].items():
                w = sb[k][name]
                if isinstance(v, torch.Tensor):
                    assert v.dtype == w.dtype and v.device == w.device and torch.equal(v, w)
                else:
                    assert v == w


@pytest.mark.parametrize('optimizer', ['adam', 'adafactor'])
def test_folder_rotation_and_bit_for_bit_resume(tmp_path, optimizer):
    folder = tmp_path / 'ckpts'
    kw = dict(optimizer=optimizer, checkpoint_path=str(folder), checkpoint_every=2,
              max_checkpoints_keep=2)
    a = _trainer(**kw)
    assert os.path.isdir(folder) and a.all_checkpoints_sorted == []
    for i in range(5):
        a.step_with_batch(_batch(4, seed=i), max_batch_size=2)
    names = lambda tr: [os.path.basename(p) for p in tr.all_checkpoints_sorted]
    assert names(a) == ['checkpoint.4.ckpt', 'checkpoint.2.ckpt']
    a.forward(**_batch(3, seed=7))        # the two-phase API checkpoints on update
    a.update()
    assert names(a) == ['checkpoint.6.ckpt', 'checkpoint.4.ckpt']
    if optimizer == 'adafactor':
        momenta = [s['momentum'] for s in a.optimizers[0].state.values() if 'momentum' in s]
        assert momenta and all(m.dtype == torch.bfloat16 for m in momenta)

    b = _trainer(seed=1, **kw)            # resumes from the newest at construction
    assert b.num_steps_taken(1) == 6
    _assert_same_state(a, b)
    a.generator.manual_seed(3)
    b.generator.manual_seed(3)
    assert a.step_with_batch(_batch(4, seed=9)) == b.step_with_batch(_batch(4, seed=9))
    _assert_same_state(a, b)

    b.load_from_checkpoint_folder(last_total_steps=4)
    assert b.num_steps_taken(1) == 4
    c = _trainer(seed=2, **{**kw, 'max_checkpoints_keep': 0})   # resumes at 6
    c.step_with_batch(_batch(2))          # 7: no checkpoint due
    c.save_to_checkpoint_folder()         # 0 keeps every checkpoint
    assert names(c) == ['checkpoint.7.ckpt', 'checkpoint.6.ckpt', 'checkpoint.4.ckpt']


class SlowFS(LocalFS):
    """Local files whose writer waits first, so training moves on meanwhile."""

    def __init__(self, fail=False):
        self.fail = fail

    def open(self, path, mode='rb'):
        if 'w' in mode:
            import time
            time.sleep(0.3)
            if self.fail:
                raise OSError(f'cannot write {path}')
        return super().open(path, mode)


def test_async_save_writes_the_state_it_was_called_with(tmp_path):
    a = _trainer(checkpoint_fs=SlowFS())
    a.step_with_batch(_batch(2))
    before = copy.deepcopy(a.unets[0].state_dict())
    path = tmp_path / 'async.ckpt'
    a.save(path, async_save=True)
    a.step_with_batch(_batch(2, seed=1))  # moves the weights while the thread writes
    assert a.num_steps_taken(1) == 2 and not os.path.exists(path)
    a.save(tmp_path / 'after.ckpt')       # joins the writer first
    b = _trainer(seed=1)
    b.load(path)
    assert b.num_steps_taken(1) == 1
    for k, v in b.unets[0].state_dict().items():
        assert torch.equal(v, before[k]), k
    b.load(tmp_path / 'after.ckpt')
    assert b.num_steps_taken(1) == 2

    failing = _trainer(checkpoint_fs=SlowFS(fail=True))
    failing.save(tmp_path / 'never.ckpt', async_save=True)
    with pytest.raises(OSError, match='cannot write'):
        failing.save(tmp_path / 'next.ckpt')


def test_trainer_from_imagen_checkpoint_path(tmp_path):
    a = _trainer()
    for i in range(2):
        a.step_with_batch(_batch(4, seed=i))
    path = str(tmp_path / 'described.ckpt')
    a.save(path)
    bundle = torch.load(path, weights_only=False)
    assert bundle['imagen_type'] == 'original' and bundle['imagen_params'] == a.imagen._config

    c = it.ImagenTrainer(imagen_checkpoint_path=path, device=CPU, verbose=False)
    assert c.imagen._config == a.imagen._config and c.num_steps_taken(1) == 0
    for k, v in a.unets[0].state_dict().items():
        assert torch.equal(c.unets[0].state_dict()[k], v)
        assert torch.equal(c.ema_unets[0].state_dict()[k], v)   # EMA starts from them
    ema = it.load_imagen_from_checkpoint(path, load_ema_if_available=True, device=CPU)
    for k, v in a.ema_unets[0].state_dict().items():
        assert torch.equal(ema.unets[0].state_dict()[k], v)
    bare = it.load_imagen_from_checkpoint(path, load_weights=False, device=CPU)
    assert not torch.equal(bare.unets[0].final_conv.bias, a.unets[0].final_conv.bias) or \
        not torch.equal(bare.unets[0].init_conv.convs[0].weight,
                        a.unets[0].init_conv.convs[0].weight)
    with pytest.raises(ValueError):
        it.ImagenTrainer(imagen=a.imagen, imagen_checkpoint_path=path)


# --- a bundle the JAX trainer wrote ----------------------------------------------------------

SIZES, STEPS = (16, 32), (3, 2)
JAX_SR = {k: list(v) if isinstance(v, tuple) else v for k, v in SR_CFG.items()
          if k != 'lowres_cond'}
JAX_IMAGEN = dict(unets=[{'is_null': True}, JAX_SR], image_sizes=list(SIZES),
                  timesteps=list(STEPS), text_embed_dim=16, cond_drop_prob=0.1)


@pytest.fixture(scope='module')
def jax_bundle(tmp_path_factory):
    """(path, JAX imagen, its online and EMA params): a JAX trainer's
    msgpack bundle of a NullUnet + SR cascade with seeded weights."""
    jimagen = JImagenConfig(**JAX_IMAGEN).create()
    trainer = JTrainer(imagen=jimagen, verbose=False)
    sr = jimagen.unets[1]
    x, time = jnp.zeros((1, 32, 32, 3)), jnp.zeros((1,))
    kw = dict(text_embeds=jnp.zeros((1, 8, 16)), text_mask=jnp.ones((1, 8), bool),
              lowres_cond_img=x, lowres_noise_times=time)
    online, ema = (random_params(sr, x, time, **kw, seed=s) for s in (90, 91))
    null = {'params': {'dummy': jnp.zeros((1,))}}
    trainer.params = [null, jparams(online)]
    trainer.ema_params = [null, jparams(ema)]
    trainer.opt_states = [opt.init(p) for opt, p in zip(trainer._optimizers, trainer.params)]
    trainer.steps[1] = 5
    path = str(tmp_path_factory.mktemp('jax') / 'jax.ckpt')
    trainer.save(path)
    return path, jimagen, online, ema


def test_jax_checkpoint_serves_from_the_port(jax_bundle):
    path, jimagen, _, ema = jax_bundle
    with open(path, 'rb') as f:
        assert not f.read(2).startswith(b'PK')   # msgpack, not a torch.save zip
    timagen = it.load_imagen_from_checkpoint(path, load_ema_if_available=True, device=CPU)
    assert isinstance(timagen.unets[0], it.NullUnet) and timagen.image_sizes == SIZES
    expected = state_dict_from_jax(ema)
    for k, v in timagen.unets[1].state_dict().items():
        assert torch.equal(v, expected[k]), k

    b = 2
    r = rng(92)
    mask = np.ones((b, 8), bool)
    mask[0, 5:] = False
    emb = randn(r, b, 8, 16) * mask[..., None]
    start = r.rand(b, SIZES[0], SIZES[0], 3).astype(np.float32)
    init, steps = randn(r, b, 32, 32, 3), randn(r, STEPS[1], b, 32, 32, 3)
    key = jax.random.PRNGKey(0)
    ref = jimagen.sample(({'params': {'dummy': jnp.zeros((1,))}}, jparams(ema)), key,
                         text_embeds=jnp.asarray(emb), text_masks=jnp.asarray(mask),
                         cond_scale=3., start_at_unet_number=2,
                         start_image_or_video=jnp.asarray(start), use_tqdm=False,
                         noise_override=[None, (jnp.asarray(init), jnp.asarray(steps))])
    lowres = t(np.asarray(jax.random.normal(jax.random.fold_in(key, 1000 + 1), (b, 32, 32, 3))))
    out = timagen.sample(text_embeds=t(emb), text_masks=t(mask), cond_scale=3.,
                         start_at_unet_number=2, start_image_or_video=t(start),
                         noise_override=[None, (t(init), t(steps), lowres)])
    assert out.shape == (b, 32, 32, 3)
    assert max_abs(out, ref) <= 1e-2

    server = it.ImagenServer.from_checkpoint(path, device=CPU, batch_size=b, text_len=8,
                                             cond_scale=3., warmup=False)
    for k, v in server.imagen.unets[1].state_dict().items():
        assert torch.equal(v, expected[k]), k
    online_server = it.ImagenServer.from_checkpoint(path, load_ema=False, device=CPU,
                                                    warmup=False)
    assert not torch.equal(online_server.imagen.unets[1].final_conv.weight,
                           server.imagen.unets[1].final_conv.weight)


def test_port_trainer_takes_the_jax_weights_only(jax_bundle):
    path, _, online, ema = jax_bundle
    trainer = it.ImagenTrainerConfig(imagen=JAX_IMAGEN, verbose=False,
                                     only_train_unet_number=2).create(device=CPU)
    with pytest.raises(ValueError, match='only_model=True'):
        trainer.load(path)
    trainer.load(path, only_model=True)
    assert trainer.num_steps_taken(2) == 0   # optimiser state and counts stay the port's
    for module, params in ((trainer.unets[1], online), (trainer.ema_unets[1], ema)):
        expected = state_dict_from_jax(params)
        for k, v in module.state_dict().items():
            assert torch.equal(v, expected[k]), k
    loss = trainer.step_with_batch(dict(images=torch.rand(2, 32, 32, 3),
                                        text_embeds=torch.randn(2, 8, 16)), unet_number=2)
    assert np.isfinite(loss)


def test_flax_msgpack_reader_matches_flax(monkeypatch):
    """`read_flax_msgpack` decodes what flax writes as flax's own reader does:
    arrays (bf16 widened to fp32), numpy scalars, complex numbers, lists
    stored as index dicts, and arrays split into chunks."""
    from flax import serialization

    from imagen_tpu_torch.utils.checkpoint_io import read_flax_msgpack, restore_index_dicts
    monkeypatch.setattr(serialization, 'MAX_CHUNK_SIZE', 64)   # chunk anything past 64 bytes
    r = rng(3)
    tree = {'w': r.randn(5, 7).astype(np.float32), 'h': jnp.asarray(r.randn(3, 4), jnp.bfloat16),
            'steps': np.array([4, 9]), 'lr': np.float32(0.5), 'z': 1 + 2j, 'name': 'x',
            'nested': {'list': [np.ones(3, np.int32), 2.5]}}
    data = serialization.msgpack_serialize(serialization.to_state_dict(tree))
    mine, ref = read_flax_msgpack(data), serialization.msgpack_restore(data)
    flat = lambda d, p='': {f'{p}{k}': v for key, val in d.items()   # noqa: E731
                            for k, v in (flat(val, f'{key}/').items() if isinstance(val, dict)
                                         else [(key, val)])}
    got, expected = flat(mine), flat(ref)
    assert got.keys() == expected.keys()
    for k, v in expected.items():
        assert np.array_equal(np.asarray(got[k], np.float64 if k == 'h' else None),
                              np.asarray(v, np.float64 if k == 'h' else None)), k
    assert got['h'].dtype == np.float32 and mine['z'] == 1 + 2j
    assert restore_index_dicts(mine['nested'])['list'][1] == 2.5
