"""The port's parallel layer in one process, against the JAX package's.

- The placement rules (`param_sharding_rules`, `zero_sharding_rules`,
  `fsdp_sharding_rules`) against JAX's on the same leaves, on ('data',
  'model') meshes of 8 ranks (a fake process group here; 8 virtual devices
  on the JAX side): `tests/test_tensor_parallel.py`'s dict in JAX layout, a
  module holding those weights as Linears (JAX's out-feature axis is the
  port's dim 0), and every leaf of the tiny unet of `tests/test_parallel.py`,
  the JAX leaf's axis read in the port's tensor through the weights bridge
  (each JAX leaf an arange): the same leaves are cut, on the same axis, by
  the same factor.
- `ParallelConfig`: its JSON round trip, `model_dump()` against the JAX
  model's, a trainer config's block, `apply_parallel`, and a trainer built
  from a config with `parallel: {data: 8, fsdp: 64}` whose state is cut 1/8
  (and a second trainer in the process refused).
- `shard_params`, `shard_opt_state`, `shard_params_fsdp`: DTensors whose
  blocks and placements are the rules'.
- A mesh of one rank (a real gloo group): `fsdp` and ZeRO-1 cut nothing and
  a step equals the plain trainer's; a sharded checkpoint round trip,
  written asynchronously; `print_unet_devices`.
- `host_offload` / `device_restore`; a directory the JAX package's orbax
  backend wrote raises an error that points to the msgpack bundle.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import Replicate, Shard

from torch_port_bridge import random_params
import torch_parallel_worker as W

import imagen_tpu.configs as jconfigs
import imagen_tpu.parallel.mesh as jmesh
from imagen_tpu.diffusion.imagen import Imagen as JImagen
from imagen_tpu.models.unet2d import Unet as JUnet
from imagen_tpu.trainer import ImagenTrainer as JTrainer

import imagen_tpu_torch as it
from imagen_tpu_torch import configs
from imagen_tpu_torch.parallel import mesh as tmesh
from imagen_tpu_torch.utils import sharded_ckpt
from imagen_tpu_torch.utils._ref_keys import ref_key_for
from imagen_tpu_torch.utils.port_weights import state_dict_from_jax

CPU = 'cpu'


@pytest.fixture
def fake_world():
    """A process group of 8 ranks in which this process is rank 0 and every
    collective returns at once: meshes and placements, no numbers."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group('fake', store=FakeStore(), rank=0, world_size=8)
    try:
        yield
    finally:
        dist.destroy_process_group()
        it.ImagenTrainer.locked = False


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group('gloo', store=dist.FileStore(str(tmp_path / 'store'), 1), rank=0,
                            world_size=1)
    try:
        yield tmesh.create_mesh(device=CPU)
    finally:
        dist.destroy_process_group()


def _jax_axes(sharding):
    """{mesh axis: array axis} of a NamedSharding."""
    return {name: axis for axis, name in enumerate(sharding.spec) if name is not None}


def _port_axes(placements):
    return {name: p.dim for name, p in zip(tmesh.AXES, placements) if isinstance(p, Shard)}


def test_tp_rules_on_the_jax_tests_dict(fake_world):
    shapes = {'big': (512, 256), 'small': (8,), 'odd': (128, 509)}
    jspecs = jmesh.param_sharding_rules(jmesh.create_mesh(data=4, model=2),
                                        {k: jnp.zeros(s) for k, s in shapes.items()},
                                        min_weight_size=1024)
    mesh = tmesh.create_mesh(data=4, model=2, device=CPU)
    specs = tmesh.param_sharding_rules(mesh, {k: torch.zeros(s) for k, s in shapes.items()},
                                       min_weight_size=1024)
    assert specs == {'big': (Replicate(), Shard(1)), 'small': (Replicate(), Replicate()),
                     'odd': (Replicate(), Replicate())}
    for k in shapes:
        assert _port_axes(specs[k]) == _jax_axes(jspecs[k]), k

    # the same kernels as Linears: JAX's (in, out) is the port's (out, in)
    module = nn.ModuleDict(dict(big=nn.Linear(512, 256, bias=False),
                                odd=nn.Linear(128, 509, bias=False)))
    module.register_parameter('small', nn.Parameter(torch.zeros(8)))
    specs = tmesh.param_sharding_rules(mesh, module, min_weight_size=1024)
    assert specs['big.weight'] == (Replicate(), Shard(0))
    assert specs['odd.weight'] == specs['small'] == (Replicate(), Replicate())


def _index_params():
    """The tiny unet's JAX params with every leaf an arange (its flat index)."""
    params = random_params(JUnet(**W.TINY), jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,)),
                           text_embeds=jnp.zeros((1, 8, 16)), text_mask=jnp.ones((1, 8), bool))
    return jax.tree_util.tree_map(
        lambda a: np.arange(a.size, dtype=np.float32).reshape(a.shape), params)


def _port_dim(port, shape, axis):
    """The dim of `port` (a bridged arange) along which JAX axis `axis` of
    `shape` runs: the one of its size whose step is that axis's stride."""
    stride = int(np.prod(shape[axis + 1:]))
    for d in range(port.ndim):
        if port.shape[d] == shape[axis] and port.shape[d] > 1:
            step = port.narrow(d, 1, 1).flatten()[0] - port.narrow(d, 0, 1).flatten()[0]
            if int(step) == stride:
                return d
    raise AssertionError(f'no dim of {tuple(port.shape)} is axis {axis} of {shape}')


@pytest.mark.parametrize('data, model', [(8, 1), (4, 2)])
@pytest.mark.parametrize('rule', ['param_sharding_rules', 'zero_sharding_rules',
                                  'fsdp_sharding_rules'])
def test_rules_match_jax_on_every_leaf_of_the_tiny_unet(fake_world, rule, data, model):
    params = _index_params()
    jspecs = getattr(jmesh, rule)(jmesh.create_mesh(data=data, model=model), params, 64)
    port = state_dict_from_jax(params)
    unet = it.Unet(**W.TINY, device=CPU)
    specs = getattr(tmesh, rule)(tmesh.create_mesh(data=data, model=model, device=CPU), unet, 64)
    leaves = jax.tree_util.tree_leaves_with_path(params)
    shardings = jax.tree_util.tree_leaves(jspecs)
    assert len(leaves) == len(shardings) == len(specs) == len(port)
    cut = 0
    for (path, leaf), sharding in zip(leaves, shardings):
        key = ref_key_for('/'.join(p.key for p in path))
        expected = {name: _port_dim(port[key], leaf.shape, axis)
                    for name, axis in _jax_axes(sharding).items()}
        assert _port_axes(specs[key]) == expected, (key, leaf.shape, sharding.spec)
        cut += bool(expected)
    # the rule cuts the tiny unet at 64 elements, except columns over a 'model' of 1
    assert cut >= 20 if rule != 'param_sharding_rules' or model > 1 else cut == 0


def test_shard_params_places_blocks_by_the_rules(fake_world):
    mesh = tmesh.create_mesh(data=4, model=2, device=CPU)
    unet = it.Unet(**W.TINY, device=CPU)
    full = dict(unet.named_parameters())
    for place, rule in ((tmesh.shard_params_fsdp, tmesh.fsdp_sharding_rules),
                        (tmesh.shard_opt_state, tmesh.zero_sharding_rules)):
        placed, specs = place(mesh, unet, 64), rule(mesh, unet, 64)
        assert placed.keys() == full.keys()
        for name, dt in placed.items():
            assert tuple(dt.placements) == specs[name] and dt.shape == full[name].shape
            factor = int(np.prod([mesh.size(i) for i, p in enumerate(specs[name])
                                  if isinstance(p, Shard)]))
            assert dt.to_local().numel() * factor == full[name].numel(), name
            # rank 0 of every axis holds the first block of each cut dim
            expected = full[name].detach()
            for p in specs[name]:
                if isinstance(p, Shard):
                    expected = expected.narrow(p.dim, 0, dt.to_local().shape[p.dim])
            assert torch.equal(dt.to_local(), expected), name
    placed = tmesh.shard_params(mesh, unet, min_weight_size=64)
    assert any(dt.to_local().shape != dt.shape for dt in placed.values())


def test_parallel_config_round_trip_and_dump():
    raw = json.loads('{"data": 4, "model": 2, "shard_optimizer_states": true}')
    mine, theirs = configs.ParallelConfig(**raw), jconfigs.ParallelConfig(**raw)
    assert mine.model_dump() == theirs.model_dump()
    assert configs.ParallelConfig(**json.loads(mine.model_dump_json())) == mine
    for block in ({'data': 8, 'fsdp': True}, {'fsdp': 64}, {}):
        assert (configs.ParallelConfig(**block).model_dump()
                == jconfigs.ParallelConfig(**block).model_dump())
    imagen = dict(unets=[W.TINY], image_sizes=[16], text_embed_dim=16, timesteps=4)
    mine = configs.ImagenTrainerConfig(imagen=imagen, parallel={'data': 8, 'fsdp': 64})
    theirs = jconfigs.ImagenTrainerConfig(imagen=imagen, parallel={'data': 8, 'fsdp': 64})
    assert mine.model_dump() == theirs.model_dump()
    assert isinstance(mine.parallel, configs.ParallelConfig)


def test_apply_parallel(fake_world):
    assert configs.apply_parallel({'lr': 1e-4}) == {'lr': 1e-4}
    assert configs.apply_parallel({'lr': 1e-4, 'parallel': None}) == {'lr': 1e-4}
    kwargs = configs.apply_parallel({'lr': 1e-4, 'parallel': {'data': 4, 'model': 2,
                                                              'shard_optimizer_states': True}},
                                    device=CPU)
    assert kwargs['lr'] == 1e-4 and 'parallel' not in kwargs
    assert tmesh.mesh_shape(kwargs['mesh']) == {'data': 4, 'model': 2}
    assert kwargs['shard_optimizer_states'] is True and kwargs['fsdp'] is False
    block = configs.ParallelConfig(fsdp=64)
    kwargs = configs.apply_parallel({'parallel': block}, device=CPU)
    assert tmesh.mesh_shape(kwargs['mesh']) == {'data': 8, 'model': 1} and kwargs['fsdp'] == 64
    with pytest.raises(ValueError, match='8 devices cannot form a 3x1 mesh'):
        configs.apply_parallel({'parallel': {'data': 3}}, device=CPU)


def test_parallel_block_builds_a_sharded_trainer(fake_world):
    cfg = configs.ImagenTrainerConfig(
        imagen=dict(unets=[W.TINY], image_sizes=[16], text_embed_dim=16, timesteps=4),
        parallel=dict(data=8, fsdp=64), use_ema=True, verbose=False)
    trainer = cfg.create(device=CPU)
    assert tmesh.mesh_shape(trainer.mesh) == {'data': 8, 'model': 1}
    assert trainer._fsdp_enabled() and not trainer._zero_enabled()
    full = {n: tuple(p.shape) for n, p in trainer.unets[0].named_parameters()}
    trainer._ensure_state(0)
    layout = trainer.layouts[0]
    cut = [(n, p) for n, p in trainer.unets[0].named_parameters() if p in layout.info]
    assert len(cut) >= 20
    for n, p in cut:
        assert p.numel() * 8 == int(np.prod(full[n])), n
    assert sum(p in layout.info for p in trainer.ema_unets[0].parameters()) == len(cut)
    assert trainer.is_distributed and trainer.is_main and trainer.can_checkpoint
    with pytest.raises(RuntimeError, match='once per process'):
        it.ImagenTrainer(it.Imagen((it.Unet(**W.TINY, device=CPU),), **W.IMAGEN, device=CPU))


def test_unet_devices_and_state_made_on_every_unet(one_rank, capsys):
    trainer = W.make_trainer(mesh=one_rank, fsdp=64, verbose=True)
    trainer.reset_ema_unets_all_one_device()
    assert all(opt is not None for opt in trainer.optimizers)
    trainer.print_unet_devices()
    out = capsys.readouterr().out
    assert 'unet 0: cpu, 0 of 240 tensors cut over the mesh' in out
    assert 'ema unet 0: cpu' in out


def test_one_rank_mesh_cuts_nothing_and_steps_as_the_plain_trainer(one_rank):
    batch = W.global_batch()
    plain = W.make_trainer()
    expected = W.steps(plain, batch, n=2)
    for options in (dict(fsdp=64), dict(shard_optimizer_states=64), {}):
        trainer = W.make_trainer(mesh=one_rank, **options)
        assert W.steps(trainer, batch, n=2) == expected, options
        assert not any(trainer.layouts[0].param_splits.values())
        for k, v in plain.unets[0].state_dict().items():
            assert torch.equal(trainer.unets[0].state_dict()[k], v), (options, k)


def test_one_rank_sharded_checkpoint_round_trip(one_rank, tmp_path):
    trainer = W.make_trainer(mesh=one_rank, fsdp=64, checkpoint_backend='orbax')
    W.steps(trainer, W.global_batch(), n=2)
    trainer.save(tmp_path / 'ckpt', async_save=True)
    trainer._wait_for_pending_save()   # the write's future, as the next save or load waits
    assert sharded_ckpt.is_orbax_checkpoint(tmp_path / 'ckpt')
    assert 'model.0.final_conv.weight' in sharded_ckpt.saved_keys(tmp_path / 'ckpt')
    fresh = W.make_trainer(mesh=one_rank, fsdp=64, checkpoint_backend='orbax')
    fresh.load(tmp_path / 'ckpt')
    assert fresh.steps.tolist() == [2]
    for k, v in trainer.unets[0].state_dict().items():
        assert torch.equal(fresh.unets[0].state_dict()[k], v), k
    for t in (trainer, fresh):
        t.generator.manual_seed(3)
    assert trainer.step_with_batch(W.global_batch()) == fresh.step_with_batch(W.global_batch())


def test_sharded_save_keeps_the_overwrite_contract(one_rank, tmp_path):
    """A sharded save over an existing directory raises with overwrite=False,
    as the bundle's does, and round-trips with overwrite=True; an fs other
    than the local one, which the sharded writer cannot write through, is
    refused before anything is written."""
    trainer = W.make_trainer(mesh=one_rank, fsdp=64, checkpoint_backend='orbax')
    W.steps(trainer, W.global_batch(), n=1)
    trainer.save(tmp_path / 'ckpt')
    with pytest.raises(FileExistsError):
        trainer.save(tmp_path / 'ckpt', overwrite=False)
    W.steps(trainer, W.global_batch(), n=1)
    trainer.save(tmp_path / 'ckpt', overwrite=True)
    fresh = W.make_trainer(mesh=one_rank, fsdp=64, checkpoint_backend='orbax')
    fresh.load(tmp_path / 'ckpt')
    assert fresh.steps.tolist() == [2]
    for k, v in trainer.unets[0].state_dict().items():
        assert torch.equal(fresh.unets[0].state_dict()[k], v), k

    import fsspec
    remote = W.make_trainer(checkpoint_backend='orbax', checkpoint_fs=fsspec.filesystem('memory'))
    with pytest.raises(ValueError, match='local filesystem'):
        remote.save(tmp_path / 'remote')
    assert not (tmp_path / 'remote').exists()


def test_host_offload_and_device_restore():
    unet = it.Unet(**W.TINY, device=CPU)
    assert tmesh.host_offload(unet) is unet
    tree = {'a': torch.ones(2), 'b': [torch.zeros(3), 4]}
    moved = tmesh.device_restore(tmesh.host_offload(tree), device=CPU)
    assert moved['a'].device.type == 'cpu' and moved['b'][1] == 4
    assert torch.equal(moved['b'][0], tree['b'][0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            tmesh.device_restore(tree)
        with pytest.raises(RuntimeError, match='NCCL needs a CUDA device'):
            tmesh.initialize_distributed()
    with pytest.raises(RuntimeError, match='needs a process group'):
        tmesh.create_mesh(device=CPU)


def test_a_jax_orbax_checkpoint_points_to_the_msgpack_bundle(tmp_path):
    jtrainer = JTrainer(imagen=JImagen(unets=(JUnet(**W.TINY),), **W.IMAGEN), verbose=False,
                        checkpoint_backend='orbax')
    jtrainer.save(str(tmp_path / 'jax_orbax'))
    assert sharded_ckpt.is_orbax_checkpoint(tmp_path / 'jax_orbax')
    trainer = W.make_trainer()
    with pytest.raises(ValueError, match="checkpoint_backend='msgpack'.*only_model=True"):
        trainer.load(tmp_path / 'jax_orbax')
    with pytest.raises(ValueError, match='cannot be read without orbax'):
        sharded_ckpt.saved_keys(tmp_path / 'jax_orbax')
