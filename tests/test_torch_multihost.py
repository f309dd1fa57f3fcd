"""The port's trainer on two ranks (gloo on the CPU) against its one-process
trainer and against the JAX trainer on a two-device mesh.

One spawn of two processes (`tests/torch_parallel_worker.py`, a FileStore
in a temporary folder, killed after 300 s) runs every layout on each rank's
two rows of one global batch of four, and writes what it saw; the tests
below read it.

- Against the port's one-process trainer on the global batch, at the JAX
  tests' tolerances (loss rtol 2e-4; weights and EMA rtol 1e-3, atol 5e-4):
  data parallelism (also with accumulation chunks of one row a rank, which
  the one-process trainer takes as chunks of two in the order chunk i =
  every rank's row i), ZeRO-1 with Adam and with Adafactor (factoring from
  8 rows, so that the tiny unet's weights factor), FSDP, and `data=1,
  model=2` (whose sample agrees to 2e-5).
- Layouts: per rank, FSDP's parameters, moments and EMA and ZeRO-1's
  moments at about half their bytes under data parallelism; FSDP's full
  weights emptied after a block's forward and after their backward (under
  remat too, which matches the one-process trainer).
- Draws: the ranks' times differ row for row, and together they are the
  one-process trainer's.
- A sample after FSDP's steps equals the one-process trainer's.
- Checkpoints: a sharded save under FSDP with the gather made to raise, its
  directory, a fresh trainer's load of it (the same blocks and moments) and
  its next step equal to the uninterrupted trainer's; a default bundle from
  FSDP loaded by a one-process trainer, one from ZeRO-1 loaded back into
  ZeRO-1; a checkpoint folder resumed on both ranks; only rank 0 writes.
- Ranks with unequal rows raise; the modules where kernels 6 and 10 run on
  the card see only the rank's rows; the CLI trains from a config with a
  `parallel` block.
- Against JAX: the FSDP trainer against `imagen_tpu`'s on
  `create_mesh(devices=jax.devices()[:2])` with `fsdp=64`, both with the
  draws pinned to the images as in `test_torch_train_loop.py`, three steps
  on three global batches, by its criteria (losses within 1e-4; the
  weights' change within 2% of JAX's, at most 0.1% of the weights off by
  over 1% of its largest).
"""
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from torch_port_bridge import jparams, random_params

from imagen_tpu.diffusion.imagen import Imagen as JImagen
from imagen_tpu.models.unet2d import Unet as JUnet
from imagen_tpu.parallel.mesh import create_mesh as jax_create_mesh
from imagen_tpu.trainer import ImagenTrainer as JTrainer

from imagen_tpu_torch import optim
from imagen_tpu_torch.utils.port_weights import state_dict_from_jax

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
TIMEOUT = 300


def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _spawn(folder):
    """Two ranks of the layouts' runs, and beside them two ranks of the
    command line, which join their group from the environment as torchrun
    would set it. The layouts' ranks must exit cleanly; the command line's
    exit codes and the ends of their errors go to `<folder>/cli_exits.json`
    for its test."""
    env = {**os.environ, 'PYTHONPATH': os.pathsep.join([REPO, TESTS]), 'OMP_NUM_THREADS': '1'}
    worker = os.path.join(TESTS, 'torch_parallel_worker.py')
    port = str(_free_port())
    commands = [([str(rank), str(folder)], env) for rank in (0, 1)]
    commands += [(['cli', str(rank), str(folder)],
                  {**env, 'RANK': str(rank), 'LOCAL_RANK': str(rank), 'WORLD_SIZE': '2',
                   'MASTER_ADDR': 'localhost', 'MASTER_PORT': port}) for rank in (0, 1)]
    procs = [subprocess.Popen([sys.executable, worker, *args], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for args, env in commands]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for (args, _), p, (out, err) in zip(commands[:2], procs, outs):
        assert p.returncode == 0, f'{args} failed ({p.returncode}):\n{out}\n{err[-6000:]}'
    (folder / 'cli_exits.json').write_text(json.dumps(
        [dict(code=p.returncode, err=err[-6000:]) for p, (_, err) in zip(procs[2:], outs[2:])]))


def _jax_params():
    return random_params(JUnet(**W.TINY), jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,)),
                         text_embeds=jnp.zeros((1, 8, 16)), text_mask=jnp.ones((1, 8), bool),
                         seed=11)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    folder = tmp_path_factory.mktemp('multihost')
    torch.save(state_dict_from_jax(_jax_params()), folder / 'jax_init.pt')
    _spawn(folder)
    return [torch.load(folder / f'rank{r}.pt', weights_only=False) for r in (0, 1)], folder


@pytest.fixture(scope='module')
def one_process():
    """The one-process trainer on the global batch: Adam, Adam with
    accumulation chunks in the ranks' order, and Adafactor."""
    batch = W.global_batch()
    seen, undo = W.record_times()
    trainer = W.make_trainer()
    try:
        out = dict(adam=dict(losses=W.steps(trainer, batch), times=seen[0]))
    finally:
        undo()
    out['adam'].update(W.full_state(trainer), sample=W.sample(trainer))
    order = W.chunk_order()
    trainer = W.make_trainer()
    out['accum'] = dict(losses=W.steps(trainer, {k: v[order] for k, v in batch.items()},
                                       max_batch_size=2), **W.full_state(trainer))
    factor, optim.MIN_DIM_SIZE_TO_FACTOR = optim.MIN_DIM_SIZE_TO_FACTOR, 8
    try:
        trainer = W.make_trainer(optimizer='adafactor')
        out['adafactor'] = dict(losses=W.steps(trainer, batch), **W.full_state(trainer))
    finally:
        optim.MIN_DIM_SIZE_TO_FACTOR = factor
    return out


def _held(mine, ref, what):
    np.testing.assert_allclose(mine['losses'], ref['losses'], rtol=2e-4, err_msg=what)
    for name in ('weights', 'ema'):
        for k, v in ref[name].items():
            np.testing.assert_allclose(mine[name][k].numpy(), v.numpy(), rtol=1e-3, atol=5e-4,
                                       err_msg=f'{what} {name} {k}')


def _each_rank(runs, mode, ref, what):
    ranks, _ = runs
    for rank, out in enumerate(ranks):
        _held(out[mode], ref, f'{what} rank {rank}')


def test_data_parallel_matches_one_process(runs, one_process):
    _each_rank(runs, 'ddp', one_process['adam'], 'data parallel')


def test_accumulation_chunks_match_one_process(runs, one_process):
    _each_rank(runs, 'ddp_accum', one_process['accum'], 'data parallel, chunks of 1')


def test_zero1_adam_matches_and_cuts_the_moments(runs, one_process):
    _each_rank(runs, 'zero1', one_process['adam'], 'ZeRO-1 Adam')
    for out in runs[0]:
        assert out['zero1']['bytes']['params'] == out['ddp']['bytes']['params']
        assert out['zero1']['bytes']['ema'] == out['ddp']['bytes']['ema']
        assert 0.45 < out['zero1']['bytes']['optim'] / out['ddp']['bytes']['optim'] < 0.6


def test_zero1_adafactor_matches_one_process(runs, one_process):
    _each_rank(runs, 'zero1_adafactor', one_process['adafactor'], 'ZeRO-1 Adafactor')
    for out in runs[0]:
        assert out['zero1_adafactor']['bytes']['params'] == out['ddp']['bytes']['params']


def test_fsdp_matches_and_cuts_params_moments_and_ema(runs, one_process):
    _each_rank(runs, 'fsdp', one_process['adam'], 'FSDP')
    for out in runs[0]:
        for kind in ('params', 'optim', 'ema'):
            assert 0.45 < out['fsdp']['bytes'][kind] / out['ddp']['bytes'][kind] < 0.6, kind


def test_fsdp_reshards_after_the_forward(runs, one_process):
    """The full weights are emptied after each block's forward and after
    their backward, gathered again in between (under remat too, whose
    recompute reads them): the steps still equal the one process's."""
    _each_rank(runs, 'fsdp_remat', one_process['adam'], 'FSDP under remat')
    for out in runs[0]:
        held = out['fsdp_held']
        assert held['full'] > 0 and held['after_forward'] == held['after_backward'] == 0, held
        assert held['after_release'] == 0, held


def test_model_axis_matches_one_process_and_samples(runs, one_process):
    _each_rank(runs, 'tp', one_process['adam'], 'data=1, model=2')
    for out in runs[0]:
        assert out['tp']['bytes']['params'] < out['ddp']['bytes']['params']
        np.testing.assert_allclose(out['tp']['sample'].numpy(),
                                   one_process['adam']['sample'].numpy(), atol=2e-5, rtol=1e-5)


def test_draws_cover_the_global_batch(runs, one_process):
    (r0, r1), _ = runs
    t0, t1 = r0['ddp']['times'], r1['ddp']['times']
    assert t0.shape == t1.shape == (2,)
    assert bool((t0 != t1).all())
    torch.testing.assert_close(torch.cat([t0, t1]), one_process['adam']['times'], rtol=0, atol=0)


def test_fsdp_sample_matches_one_process(runs, one_process):
    for out in runs[0]:
        assert out['fsdp']['sample'].shape == (2, 16, 16, 3)
        np.testing.assert_allclose(out['fsdp']['sample'].numpy(),
                                   one_process['adam']['sample'].numpy(), atol=1e-4, rtol=1e-4)


def test_sharded_checkpoint_gathers_nothing_and_resumes(runs):
    for rank, out in enumerate(runs[0]):
        sharded = out['sharded']
        assert sharded['files'] == ['arrays', 'meta.json'], sharded['files']
        assert '.metadata' in sharded['arrays'] and len(sharded['arrays']) >= 3
        assert sharded['steps'] == [2, 2]
        assert sharded['blocks_equal'] and sharded['moments_equal'], rank
        full = {tuple(v.shape) for v in out['fsdp']['weights'].values()}
        assert any(shape not in full for shape in sharded['block_shapes'])
        assert sharded['next'][0] == sharded['next'][1], sharded['next']


def test_bundles_load_across_layouts(runs):
    ranks, folder = runs
    trainer = W.make_trainer()
    trainer.load(str(folder / 'fsdp.ckpt'))
    state = W.full_state(trainer)
    for k, v in ranks[0]['fsdp']['weights'].items():
        assert torch.equal(state['weights'][k], v), k
        assert torch.equal(state['ema'][k], ranks[0]['fsdp']['ema'][k]), k
    assert state['steps'] == W.STEPS
    assert np.isfinite(trainer.step_with_batch(W.global_batch()))
    for out in ranks:
        assert out['zero1_reload']['same'] and out['zero1_reload']['steps'] == W.STEPS
        assert out['zero1_reload']['next'][0] == out['zero1_reload']['next'][1]


def test_checkpoint_folder_resumes_on_both_ranks(runs):
    for out in runs[0]:
        assert out['folder']['files'] == ['checkpoint.2.ckpt']
        assert out['folder']['steps'] == 2 and out['folder']['same']


def test_only_rank_zero_writes(runs):
    (r0, r1), folder = runs
    assert r0['fsdp']['save_calls'] == [str(folder / 'fsdp.ckpt')]
    assert r1['fsdp']['save_calls'] == []


def test_ranks_with_unequal_rows_raise(runs):
    for out in runs[0]:
        assert out['ragged'] is not None and '[2, 1] rows' in out['ragged'], out['ragged']


def test_kernel_sites_see_only_the_ranks_rows(runs):
    for out in runs[0]:
        rows = out['ddp']['rows']
        kinds = {kind for kind, _ in rows}
        assert kinds == {'SameConv3x3', 'FeedForward'}, kinds
        assert {n for _, n in rows} == {2}


def test_cli_trains_from_a_parallel_block(runs):
    """Fresh processes with torchrun's environment: the command joins the
    group, trains and leaves it; four items split over two ranks of batch
    2 make one step."""
    _, folder = runs
    for rank, exit in enumerate(json.loads((folder / 'cli_exits.json').read_text())):
        assert exit['code'] == 0, (rank, exit)
    for rank in (0, 1):
        out = json.loads((folder / f'cli{rank}.json').read_text())
        assert out == dict(joined_before=False, joined_after=False), out
    bundle = torch.load(folder / 'cli.ckpt', weights_only=False)
    assert bundle['steps'].tolist() == [1]


def _times_and_noise(x):
    mean = x.mean((1, 2, 3)) * 13.7
    return 0.05 + 0.9 * (mean - jnp.floor(mean)), jnp.sin(x * 12.9898 + 78.233) * 1.7


def test_fsdp_matches_the_jax_mesh_trainer(runs, monkeypatch):
    original = JImagen.p_losses

    def p_losses(self, unet, variables, x_start, times, key, **kw):
        times, noise = _times_and_noise(x_start)
        return original(self, unet, variables, x_start, times, key, **{**kw, 'noise': noise})

    monkeypatch.setattr(JImagen, 'p_losses', p_losses)
    params = _jax_params()
    mesh = jax_create_mesh(devices=jax.devices()[:2])
    trainer = JTrainer(imagen=JImagen(unets=(JUnet(**W.TINY),), **W.IMAGEN), mesh=mesh,
                       fsdp=W.MIN_SIZE, **{k: v for k, v in W.JAX_TRAINER.items()
                                           if k != 'seed'})
    trainer.params[0] = trainer._place_params(jparams(params))
    trainer.ema_params[0] = trainer._place_params(jparams(params))
    trainer.opt_states[0] = trainer._place_opt_state(
        trainer._optimizers[0].init(trainer.params[0]))
    losses = [trainer.step_with_batch(W.global_batch(seed)) for seed in W.JAX_BATCHES]
    start = state_dict_from_jax(params)

    for rank, out in enumerate(runs[0]):
        mine = out['jax']
        for a, b in zip(mine['losses'], losses):
            assert np.isfinite(b) and abs(a - b) <= 1e-4, (rank, mine['losses'], losses)
        for name, tree in (('weights', trainer.params[0]), ('ema', trainer.ema_params[0])):
            expected = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree))
            got = torch.cat([(mine[name][k] - start[k]).flatten() for k in start])
            ref = torch.cat([(expected[k] - start[k]).flatten() for k in start])
            assert float(ref.abs().max()) >= 2 * W.JAX_TRAINER['lr'], name
            off = (got - ref).abs() > 1e-2 * ref.abs().max()
            assert float((got - ref).norm() / ref.norm()) <= 2e-2, (rank, name)
            assert float(off.float().mean()) <= 1e-3, (rank, name)
