"""One rank of the two-rank runs of `tests/test_torch_multihost.py`.

    python tests/torch_parallel_worker.py <rank> <folder>
    python tests/torch_parallel_worker.py cli <rank> <folder>

Joins a two-rank gloo group on the CPU over a FileStore in `folder`, runs
the port's trainer in every layout on its rows of one global batch, and
writes what it saw to `<folder>/rank<rank>.pt`; the test holds that to the
one-process trainer (built by the same helpers here) and to the JAX mesh
trainer. Imports no JAX. The second form is one rank of the command
line's `train` (`run_cli`), started with the rendezvous in its environment.
"""
import os
import sys
import traceback

import numpy as np
import torch

torch.set_num_threads(1)   # two ranks on the CPU: one thread each

import imagen_tpu_torch as it   # noqa: E402
from imagen_tpu_torch import optim   # noqa: E402

CPU = 'cpu'
TINY = dict(dim=8, dim_mults=(1, 2), text_embed_dim=16, cond_dim=8, attn_dim_head=4,
            attn_heads=2, attn_pool_num_latents=2, max_text_len=8, layer_attns=False,
            layer_cross_attns=(False, True))
IMAGEN = dict(image_sizes=(16,), text_embed_dim=16, timesteps=4, cond_drop_prob=0.)
TRAINER = dict(lr=1e-3, max_grad_norm=1.0, use_ema=True, ema_update_after_step=0,
               ema_update_every=1, verbose=False, seed=0)
MIN_SIZE = 64        # the least leaf that is cut: the tiny unet's are far below 2^15
STEPS = 3
ROWS = 4             # the global batch: two rows a rank
# JAX comparison: Adam moves a weight by about lr whatever its gradient, so a
# near-zero gradient's fp32 sign sends it either way; lr bounds the drift
JAX_TRAINER = dict(lr=1e-5, max_grad_norm=1.0, use_ema=True, ema_update_after_step=0,
                   ema_update_every=1, verbose=False, seed=0)
# a new global batch each step, as a run has: one batch again and again steps the
# same near-zero gradients each time, so their sign flips add up
JAX_BATCHES = (1, 2, 3)


def tiny_imagen(state=None, **unet_options):
    """The tiny cascade, its weights from seed 0 (the final conv drawn too,
    so that every weight gets a gradient) or from `state`."""
    torch.manual_seed(0)
    imagen = it.Imagen((it.Unet(**TINY, **unet_options, device=CPU),), **IMAGEN, device=CPU)
    unet = imagen.unets[0]
    with torch.no_grad():
        for p in unet.final_conv.parameters():
            p.normal_(0, 0.02)
    if state is not None:
        unet.load_state_dict(state)
    return imagen


def make_trainer(imagen=None, **kwargs):
    """A trainer of the tiny cascade. A process makes one trainer a run when
    distributed (`ImagenTrainer.locked`); these runs make several, one after
    another, so the lock is released before each."""
    it.ImagenTrainer.locked = False
    return it.ImagenTrainer(imagen if imagen is not None else tiny_imagen(),
                            **{**TRAINER, **kwargs})


def global_batch(seed=1):
    r = np.random.RandomState(seed)
    mask = np.arange(8)[None] < r.randint(3, 9, (ROWS, 1))
    return dict(images=r.rand(ROWS, 16, 16, 3).astype(np.float32),
                text_embeds=(r.randn(ROWS, 8, 16) * mask[..., None]).astype(np.float32),
                text_masks=mask)


def rows_of(batch, rank, n=2):
    b = len(batch['images']) // n
    return {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}


def chunk_order(n=2, per_rank=2):
    """The one-process row order of accumulation chunks of one row a rank:
    chunk i is every rank's row i."""
    return [r * per_rank + i for i in range(per_rank) for r in range(n)]


def sample_inputs(seed=5):
    r = np.random.RandomState(seed)
    return dict(text_embeds=torch.from_numpy(r.randn(2, 8, 16).astype(np.float32)),
                text_masks=torch.ones(2, 8, dtype=torch.bool))


def sample(trainer, seed=7):
    return trainer.sample(**sample_inputs(), cond_scale=1.,
                          generator=torch.Generator().manual_seed(seed))


def steps(trainer, batch, n=STEPS, **kwargs):
    return [trainer.step_with_batch(dict(batch), **kwargs) for _ in range(n)]


def full_state(trainer):
    """The unet, EMA and optimiser state as a one-process trainer holds them
    (gathered: every rank calls it)."""
    from imagen_tpu_torch.utils.checkpoint_io import to_cpu
    bundle = to_cpu(trainer.state_dict())   # copies: later steps change the live tensors
    return dict(weights=bundle['model'][0], ema=bundle['ema'][0], optim=bundle['optim0'],
                steps=int(bundle['steps'][0]))


def held_full_weights(trainer, rows):
    """Bytes that unet 1's gathered full weights hold after the forward of a
    loss with gradient and after its backward (before `release` puts the
    blocks back), against their full size."""
    unet, layout = trainer.unets[0], trainer.layouts[0]

    def gathered():
        return [p for p in unet.parameters() if not p.is_leaf]

    def held():
        return sum(p.untyped_storage().nbytes() for p in gathered())

    batch = trainer._prepare_batch(dict(rows))
    images = batch.pop('images')
    with trainer._global_rows():
        loss = trainer.imagen(images, unet_number=1, generator=trainer.generator, **batch)
    out = dict(full=tensor_bytes(gathered()), after_forward=held())
    loss.backward()
    out['after_backward'] = held()
    layout.release(unet)
    out['after_release'] = len(gathered())
    return out


def tensor_bytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def state_bytes(trainer):
    """This rank's bytes of parameters, optimiser state and EMA of unet 1."""
    opt = trainer.optimizers[0]
    return dict(params=tensor_bytes(trainer.unets[0].parameters()),
                optim=tensor_bytes(v for s in opt.state.values() for v in s.values()),
                ema=tensor_bytes(trainer.ema_unets[0].parameters()))


def times_and_noise(x):
    """Times in (0.05, 0.95) and unit-scale noise from the images alone, as
    `tests/test_torch_train_loop.py` pins both packages' `p_losses`."""
    mean = x.mean((1, 2, 3)) * 13.7
    return 0.05 + 0.9 * (mean - torch.floor(mean)), torch.sin(x * 12.9898 + 78.233) * 1.7


def pin_draws():
    """Make `Imagen.p_losses` take its times and noise from the images;
    returns the function that undoes it."""
    original = it.Imagen.p_losses

    def p_losses(self, unet, x_start, times, **kw):
        times, noise = times_and_noise(x_start)
        return original(self, unet, x_start, times, **{**kw, 'noise': noise})

    it.Imagen.p_losses = p_losses
    return lambda: setattr(it.Imagen, 'p_losses', original)


def record_times():
    """Record the times every `Imagen.p_losses` call gets; returns (the list,
    the function that undoes it)."""
    original, seen = it.Imagen.p_losses, []

    def p_losses(self, unet, x_start, times, **kw):
        seen.append(times.clone())
        return original(self, unet, x_start, times, **kw)

    it.Imagen.p_losses = p_losses
    return seen, lambda: setattr(it.Imagen, 'p_losses', original)


def record_rows(unet):
    """Forward pre-hooks on the `SameConv3x3` and `FeedForward` modules (where
    kernels 6 and 10 run on the card) that record each input's rows."""
    from imagen_tpu_torch.models.blocks import FeedForward, SameConv3x3
    seen = []
    handles = [m.register_forward_pre_hook(lambda m, args: seen.append(
                   (type(m).__name__, int(args[0].shape[0]))))
               for m in unet.modules() if isinstance(m, (SameConv3x3, FeedForward))]
    return seen, handles


def run(rank, folder):
    import torch.distributed as dist

    import imagen_tpu_torch.trainer as trainer_mod
    from imagen_tpu_torch.parallel import layout as layout_lib
    from imagen_tpu_torch.parallel import mesh as mesh_lib
    from imagen_tpu_torch.parallel.mesh import create_mesh

    dist.init_process_group('gloo', store=dist.FileStore(os.path.join(folder, 'store'), 2),
                            rank=rank, world_size=2)
    data_mesh = create_mesh(device=CPU)
    batch = global_batch()
    mine = rows_of(batch, rank)
    out = {}

    # data parallelism: the losses, the weights, the draws and the kernels' rows
    seen_times, undo = record_times()
    trainer = make_trainer(mesh=data_mesh)
    seen_rows, handles = record_rows(trainer.unets[0])
    out['ddp'] = dict(losses=steps(trainer, mine), times=seen_times[0], rows=seen_rows[:])
    undo()
    for h in handles:
        h.remove()
    out['ddp'].update(full_state(trainer), bytes=state_bytes(trainer))

    trainer = make_trainer(mesh=data_mesh)
    out['ddp_accum'] = dict(losses=steps(trainer, mine, max_batch_size=1),
                            **full_state(trainer))

    # ZeRO-1, Adam and Adafactor; a bundle back into ZeRO-1
    trainer = make_trainer(mesh=data_mesh, shard_optimizer_states=MIN_SIZE)
    out['zero1'] = dict(losses=steps(trainer, mine), bytes=state_bytes(trainer),
                        **full_state(trainer))
    path = os.path.join(folder, 'zero1.ckpt')
    trainer.save(path)
    again = make_trainer(mesh=data_mesh, shard_optimizer_states=MIN_SIZE)
    again.load(path)
    loaded = full_state(again)
    out['zero1_reload'] = dict(
        same=all(torch.equal(loaded['weights'][k], v)
                 for k, v in out['zero1']['weights'].items())
        and all(torch.equal(a, b) for i, s in out['zero1']['optim']['state'].items()
                for a, b in zip(s.values(), loaded['optim']['state'][i].values())
                if isinstance(a, torch.Tensor)),
        steps=loaded['steps'])
    for t in (trainer, again):
        t.generator.manual_seed(99)
    out['zero1_reload']['next'] = [t.step_with_batch(dict(mine)) for t in (trainer, again)]

    factor = optim.MIN_DIM_SIZE_TO_FACTOR
    optim.MIN_DIM_SIZE_TO_FACTOR = 8   # the tiny unet's weights factor too
    trainer = make_trainer(mesh=data_mesh, shard_optimizer_states=MIN_SIZE,
                           optimizer='adafactor')
    out['zero1_adafactor'] = dict(losses=steps(trainer, mine), bytes=state_bytes(trainer),
                                  **full_state(trainer))
    optim.MIN_DIM_SIZE_TO_FACTOR = factor

    # FSDP: the weights, the layout, a sample, the default bundle
    trainer = make_trainer(mesh=data_mesh, fsdp=MIN_SIZE)
    out['fsdp'] = dict(losses=steps(trainer, mine), bytes=state_bytes(trainer))
    out['fsdp'].update(full_state(trainer), sample=sample(trainer))
    calls = []
    save_obj = trainer_mod.save_obj
    trainer_mod.save_obj = lambda *a: (calls.append(a[1]), save_obj(*a))
    trainer.save(os.path.join(folder, 'fsdp.ckpt'))
    trainer_mod.save_obj = save_obj
    out['fsdp']['save_calls'] = calls

    # FSDP under remat (recomputed blocks read the weights gathered again in
    # the backward), and the full weights a rank holds around a step
    trainer = make_trainer(tiny_imagen(remat=True), mesh=data_mesh, fsdp=MIN_SIZE)
    out['fsdp_remat'] = dict(losses=steps(trainer, mine), **full_state(trainer))
    out['fsdp_held'] = held_full_weights(trainer, mine)

    # FSDP with sharded checkpoints: no gather while saving, resume = uninterrupted
    trainer = make_trainer(mesh=data_mesh, fsdp=MIN_SIZE, checkpoint_backend='orbax')
    steps(trainer, mine, n=2)
    path = os.path.join(folder, 'fsdp_sharded.ckpt')
    gather = layout_lib.MeshComm.gather

    def no_gather(*args):
        raise AssertionError('a sharded save must not gather the state')

    layout_lib.MeshComm.gather = no_gather
    try:
        trainer.save(path)
    finally:
        layout_lib.MeshComm.gather = gather
    fresh = make_trainer(mesh=data_mesh, fsdp=MIN_SIZE, checkpoint_backend='orbax')
    fresh.load(path)
    blocks = list(trainer.unets[0].parameters()) + list(trainer.ema_unets[0].parameters())
    fresh_blocks = list(fresh.unets[0].parameters()) + list(fresh.ema_unets[0].parameters())
    moments = [v for s in trainer.optimizers[0].state.values() for v in s.values()]
    fresh_moments = [v for s in fresh.optimizers[0].state.values() for v in s.values()]
    for t in (trainer, fresh):
        t.generator.manual_seed(99)
    out['sharded'] = dict(
        files=sorted(os.listdir(path)), arrays=sorted(os.listdir(os.path.join(path, 'arrays'))),
        steps=[int(t.steps[0]) for t in (trainer, fresh)],
        blocks_equal=all(torch.equal(a, b) for a, b in zip(blocks, fresh_blocks)),
        moments_equal=(len(moments) == len(fresh_moments)
                       and all(torch.equal(a, b) for a, b in zip(moments, fresh_moments))),
        block_shapes=[tuple(p.shape) for p in fresh.unets[0].parameters()],
        next=[t.step_with_batch(dict(mine)) for t in (trainer, fresh)])

    # a checkpoint folder resumes on both ranks
    ckpt_folder = os.path.join(folder, 'folder')
    trainer = make_trainer(mesh=data_mesh, fsdp=MIN_SIZE, checkpoint_path=ckpt_folder,
                           checkpoint_every=1, max_checkpoints_keep=1)
    steps(trainer, mine, n=2)
    before = full_state(trainer)
    resumed = make_trainer(mesh=data_mesh, fsdp=MIN_SIZE, checkpoint_path=ckpt_folder,
                           checkpoint_every=1, max_checkpoints_keep=1)
    after = full_state(resumed)
    out['folder'] = dict(files=sorted(os.listdir(ckpt_folder)), steps=after['steps'],
                         same=all(torch.equal(after['weights'][k], v)
                                  for k, v in before['weights'].items()))

    # the 'model' axis: the whole batch on both ranks, weights cut over 'model'
    # (from MIN_SIZE elements, as the JAX TP tests cut the tiny model, not 2^16)
    rules = mesh_lib.param_sharding_rules
    defaults, rules.__defaults__ = rules.__defaults__, (MIN_SIZE,)
    try:
        trainer = make_trainer(mesh=create_mesh(data=1, model=2, device=CPU))
        out['tp'] = dict(losses=steps(trainer, batch), bytes=state_bytes(trainer))
        out['tp'].update(full_state(trainer), sample=sample(trainer))
    finally:
        rules.__defaults__ = defaults

    # ranks with different row counts raise
    trainer = make_trainer(mesh=data_mesh)
    try:
        trainer.step_with_batch(rows_of(batch, rank) if rank == 0 else
                                {k: v[:1] for k, v in mine.items()})
        out['ragged'] = None
    except ValueError as e:
        out['ragged'] = str(e)

    # against the JAX mesh trainer: FSDP with the draws pinned to the images
    undo = pin_draws()
    state = torch.load(os.path.join(folder, 'jax_init.pt'))
    trainer = make_trainer(tiny_imagen(state), mesh=data_mesh, fsdp=MIN_SIZE, **JAX_TRAINER)
    out['jax'] = dict(losses=[trainer.step_with_batch(rows_of(global_batch(seed), rank))
                              for seed in JAX_BATCHES], **full_state(trainer))
    undo()

    torch.save(out, os.path.join(folder, f'rank{rank}.pt'))
    dist.destroy_process_group()


def run_cli(folder, rank):
    """`train` for one epoch of one step a rank from a config with
    `parallel: {data: 2}`, in a process that has joined no group: the
    command joins it from the environment (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT), as under torchrun. The dataset and T5 are stood in as
    `tests/test_torch_configs.py` stands them in. Writes what it saw to
    `<folder>/cli<rank>.json`."""
    import json
    from types import SimpleNamespace

    import torch.distributed as dist
    from PIL import Image

    from torch_port_bridge import TINY_T5, StandInEncoder, WordTokenizer
    from imagen_tpu_torch.cli import imagen as cli
    from imagen_tpu_torch.models import t5

    r = np.random.RandomState(3)
    items = [dict(image=Image.fromarray((r.rand(20, 18, 3) * 255).astype(np.uint8)),
                  caption=f'picture number {i}') for i in range(4)]
    sys.modules['datasets'] = SimpleNamespace(load_dataset=lambda name: {'train': items})
    model = StandInEncoder(16)
    t5.T5_CONFIGS[TINY_T5] = dict(model=model, tokenizer=WordTokenizer(), config=model.config)
    ckpt = os.path.join(folder, 'cli.ckpt')
    cfg = dict(type='original',
               imagen=dict(unets=[TINY], image_sizes=[16], timesteps=4,
                           text_encoder_name=TINY_T5, cond_drop_prob=0.1),
               trainer=dict(lr=1e-3, verbose=False, parallel=dict(data=2)),
               dataset_name='a/dataset', dataset=dict(batch_size=2, shuffle=False),
               image_label='image', url_label=None, text_label='caption',
               checkpoint_path=ckpt)
    config = os.path.join(folder, f'cli_config{rank}.json')
    with open(config, 'w') as f:
        json.dump(cfg, f)
    out = dict(joined_before=dist.is_initialized())
    cli.main(['train', '--config', config, '--unet', '1', '--epoches', '1', '--device', CPU],
             standalone_mode=False)
    out['joined_after'] = dist.is_initialized()
    with open(os.path.join(folder, f'cli{rank}.json'), 'w') as f:
        json.dump(out, f)


if __name__ == '__main__':
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        if sys.argv[1] == 'cli':
            run_cli(sys.argv[3], int(sys.argv[2]))
        else:
            run(int(sys.argv[1]), sys.argv[2])
    except Exception:
        traceback.print_exc()
        sys.exit(1)
