"""The library route for the port's parallel layer, tried on the tiny unet of
`tests/test_torch_multihost.py`: torch's own FSDP2 (`fully_shard` on each
block the port's layout gathers, then the unet), composable `replicate`,
`DistributedDataParallel` and `ZeroRedundancyOptimizer`, each on two gloo
ranks on the CPU, against the one-process run on the global batch (Adam or
the port's Adafactor at lr 1e-3, 3 steps, then a sample).

    python tests/torch_library_route.py <folder>

Prints, for each route, its losses, the largest weight difference from the
one-process run and the largest sample difference, or the error it raised.
Imports no JAX.
"""
import contextlib
import os
import subprocess
import sys
import traceback

import torch
import torch.distributed as dist

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(TESTS), TESTS]

import torch_parallel_worker as W   # noqa: E402
from imagen_tpu_torch import optim   # noqa: E402
from imagen_tpu_torch.parallel.layout import _blocks_of   # noqa: E402
from imagen_tpu_torch.parallel.rows import global_rows   # noqa: E402

ROUTES = (('fsdp2', 'adam'), ('fsdp2', 'adafactor'), ('replicate', 'adam'), ('ddp', 'adam'),
          ('zero_replicate', 'adafactor'))


def make_optimizer(params, kind, zero=False):
    optim.MIN_DIM_SIZE_TO_FACTOR = 8   # the tiny unet's weights factor too
    if kind == 'adam':
        klass, kwargs = torch.optim.Adam, dict(lr=1e-3, betas=(0.9, 0.99), eps=1e-8)
    else:
        klass, kwargs = optim.Adafactor, dict(lr=1e-3)
    if zero:
        from torch.distributed.optim import ZeroRedundancyOptimizer
        return ZeroRedundancyOptimizer(params, optimizer_class=klass, **kwargs)
    return klass(params, **kwargs)


def train_and_sample(imagen, opt, rows, ranks=1, rank=0):
    g, losses = torch.Generator().manual_seed(0), []
    for _ in range(3):
        batch = {k: torch.as_tensor(v) for k, v in rows.items()}
        images = batch.pop('images')
        with global_rows(ranks, rank) if ranks > 1 else contextlib.nullcontext():
            loss = imagen(images, unet_number=1, generator=g, **batch)
        loss.backward()
        opt.step()
        opt.zero_grad()
        loss = loss.detach()
        if ranks > 1:
            dist.all_reduce(loss)
        losses.append(float(loss) / ranks)
    imagen.eval()
    sample = imagen.sample(**W.sample_inputs(), cond_scale=1., use_tqdm=False,
                           generator=torch.Generator().manual_seed(7))
    return losses, sample


def rank_run(rank, route, kind, folder):
    dist.init_process_group('gloo', rank=rank, world_size=2, store=dist.FileStore(
        os.path.join(folder, f'store_{route}_{kind}'), 2))
    imagen = W.tiny_imagen()
    unet = imagen.unets[0]
    try:
        if route == 'fsdp2':
            from torch.distributed.device_mesh import init_device_mesh
            from torch.distributed.fsdp import fully_shard
            mesh = init_device_mesh('cpu', (2,))
            for block in _blocks_of(unet):
                if any(True for _ in block.parameters()):
                    fully_shard(block, mesh=mesh)
            fully_shard(unet, mesh=mesh)
        elif route in ('replicate', 'zero_replicate'):
            from torch.distributed._composable.replicate import replicate
            replicate(unet)
        else:
            from torch.nn.parallel import DistributedDataParallel
            imagen.unets[0] = DistributedDataParallel(unet)
        opt = make_optimizer(list(unet.parameters()), kind, zero=route == 'zero_replicate')
        losses, sample = train_and_sample(imagen, opt, W.rows_of(W.global_batch(), rank), 2, rank)
        if route == 'fsdp2':
            from torch.distributed.checkpoint.state_dict import (StateDictOptions,
                                                                 get_model_state_dict)
            state = get_model_state_dict(unet, options=StateDictOptions(full_state_dict=True))
        else:
            state = unet.state_dict()
        out = dict(losses=losses, sample=sample, state={k: v.detach().clone()
                                                        for k, v in state.items()})
    except Exception as e:
        traceback.print_exc()
        out = dict(error=f'{type(e).__name__}: {e}'.splitlines()[0])
    torch.save(out, os.path.join(folder, f'{route}_{kind}{rank}.pt'))
    dist.destroy_process_group()


def main(folder):
    os.makedirs(folder, exist_ok=True)
    env = {**os.environ, 'OMP_NUM_THREADS': '1'}
    for kind in ('adam', 'adafactor'):
        imagen = W.tiny_imagen()
        losses, sample = train_and_sample(
            imagen, make_optimizer(list(imagen.unets[0].parameters()), kind), W.global_batch())
        ref = dict(losses=losses, sample=sample, state=imagen.unets[0].state_dict())
        print(f'one process, {kind}: losses {losses}')
        for route, k in ROUTES:
            if k != kind:
                continue
            procs = [subprocess.Popen([sys.executable, __file__, folder, route, kind, str(r)],
                                      env=env, stdout=subprocess.DEVNULL,
                                      stderr=subprocess.DEVNULL) for r in (0, 1)]
            for p in procs:
                p.wait(timeout=300)
            out = torch.load(os.path.join(folder, f'{route}_{kind}0.pt'), weights_only=False)
            if 'error' in out:
                print(f'{route}, {kind}: raised {out["error"]}')
                continue
            weights = max(float((out['state'][n] - v).abs().max())
                          for n, v in ref['state'].items())
            print(f'{route}, {kind}: losses {out["losses"]}, largest weight difference '
                  f'{weights:.3e}, largest sample difference '
                  f'{float((out["sample"] - ref["sample"]).abs().max()):.3e}')


if __name__ == '__main__':
    if len(sys.argv) == 5:
        rank_run(int(sys.argv[4]), sys.argv[2], sys.argv[3], sys.argv[1])
    else:
        main(sys.argv[1])
