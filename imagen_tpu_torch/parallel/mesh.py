"""Device mesh and placement rules over `torch.distributed`; counterpart of
`imagen_tpu/parallel/mesh.py`, with the same function names.

The port runs one process per GPU, as `torch.distributed` does (`torchrun
--nproc-per-node N`): `initialize_distributed()` joins the process group
(NCCL, and the card `LOCAL_RANK`, by default) and `create_mesh()` lays its
ranks out as a `DeviceMesh` with the JAX names ('data', 'model').

- Rows: each rank passes its own rows of the global batch (`shard_batch`,
  the trainer's steps); the ranks of one 'model' group pass the same rows,
  the global batch is `data` x the local rows, and ranks whose row counts
  differ raise, as `jax.make_array_from_process_local_data` does. JAX's
  single-process form, one process handing a global batch to several
  devices, has no counterpart here: a process drives one device.
- Placements are DTensor placements, one per mesh axis, ('data', 'model'):
  `(Shard(dim), Replicate())` and so on. The rules decide as the JAX rules
  do, in the JAX package's layout: a Linear weight (out, in) is a Dense
  kernel (in, out) and a conv weight (O, I, *k) a kernel (*k, I, O), so
  JAX's last (out-feature) axis is the port weight's dim 0. Singleton dims
  that one layout holds and the other does not (a 1x1 conv kept as a Dense
  kernel, a gain kept as (C, 1, 1)) never divide an axis of size 2 or more,
  so they change no decision; between equal axes the one last in the JAX
  order is taken, as `max` over (size, axis) takes it there.
- `imagen_tpu/parallel/kernel_sharding.py` has no counterpart: under GSPMD a
  Pallas call is opaque and would have its operands replicated unless
  wrapped in `shard_map`, while here each rank launches its kernels on the
  rows it holds by construction.
"""
from __future__ import annotations

import os
from typing import Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from imagen_tpu_torch.utils.helpers import default, resolve_device

AXES = ('data', 'model')


def initialize_distributed(**kwargs):
    """Join the process group: `torch.distributed.init_process_group(**kwargs)`
    with NCCL by default, after `torch.cuda.set_device(LOCAL_RANK)`. The rank,
    world size and address come from the environment `torchrun` sets, or
    from `init_method`, `rank` and `world_size`. The CPU is used only when
    asked for (`backend='gloo'`); NCCL without a card raises."""
    backend = kwargs.setdefault('backend', 'nccl')
    if 'nccl' in str(backend):
        if not torch.cuda.is_available():
            raise RuntimeError('NCCL needs a CUDA device: pass backend="gloo" to run on the CPU')
        torch.cuda.set_device(int(os.environ.get('LOCAL_RANK', 0)))
    dist.init_process_group(**kwargs)


def create_mesh(devices: Optional[Sequence[int]] = None, data: Optional[int] = None,
                model: int = 1, device=None) -> DeviceMesh:
    """A ('data', 'model') `DeviceMesh` over `devices`, the process group's
    ranks (default: all of them, in rank order), on `device` (None: the
    card; 'cpu' when asked for)."""
    if not dist.is_initialized():
        raise RuntimeError('create_mesh needs a process group: call initialize_distributed() '
                           'first (under torchrun, or with init_method, rank and world_size)')
    world = dist.get_world_size()
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    if sorted(ranks) != list(range(world)):
        raise ValueError(f'the mesh must hold every rank of the process group once, got {ranks}')
    n = len(ranks)
    data = default(data, n // model)
    if data * model != n:
        raise ValueError(f'{n} devices cannot form a {data}x{model} mesh')
    device_type = resolve_device(device).type
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(data, model),
                      mesh_dim_names=AXES)


def mesh_shape(mesh) -> dict:
    """{'data': n, 'model': m}, as `jax.sharding.Mesh.shape`."""
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def axis_size(mesh, axis: str) -> int:
    return mesh_shape(mesh).get(axis, 1)


def mesh_device(mesh) -> torch.device:
    """This rank's device on the mesh: its current card, or the CPU."""
    if mesh.device_type == 'cuda':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device(mesh.device_type)


def batch_sharding(mesh):
    """Leading-axis data sharding for batches."""
    return (Shard(0), Replicate())


def replicated(mesh):
    return (Replicate(), Replicate())


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def check_rows(mesh, rows: int):
    """Raise unless every rank of the mesh holds `rows` rows."""
    device = mesh_device(mesh)
    counts = [torch.zeros(1, dtype=torch.int64, device=device) for _ in range(mesh.size())]
    dist.all_gather(counts, torch.tensor([rows], dtype=torch.int64, device=device))
    counts = [int(c) for c in counts]
    if len(set(counts)) > 1:
        raise ValueError(f'the ranks hold {counts} rows: every rank passes the same number of '
                         'rows of the global batch')


def shard_batch(mesh, batch, batch_axis: int = 0):
    """This rank's rows of the global batch on its device: the arrays and
    tensors of `batch` (a tensor, or a dict, list or tuple of them) as
    tensors, other values as they are. `batch_axis=1` is the accumulation
    layout (n_chunks, microbatch, ...), whose microbatch axis is the rank's
    share. Each rank passes its own rows; ranks whose row counts differ
    raise."""
    device = mesh_device(mesh)
    rows = set()

    def place(x):
        if not hasattr(x, 'shape') or len(x.shape) <= batch_axis:
            return x
        rows.add(int(x.shape[batch_axis]))
        return torch.as_tensor(x).to(device)

    placed = _tree_map(place, batch)
    if len(rows) > 1:
        raise ValueError(f'the batch holds arrays of {sorted(rows)} rows')
    check_rows(mesh, rows.pop() if rows else 0)
    return placed


def replicate(mesh, tree):
    """The values of rank 0 on every rank: a module's parameters and buffers
    are broadcast in place; a tensor tree is returned on the mesh's device,
    broadcast."""
    device = mesh_device(mesh)
    src = int(mesh.mesh.flatten()[0])
    if isinstance(tree, nn.Module):
        with torch.no_grad():
            for t in (*tree.parameters(), *tree.buffers()):
                dist.broadcast(t.data, src)
        return tree

    def bcast(x):
        if not isinstance(x, torch.Tensor):
            return x
        x = x.detach().to(device).clone()
        dist.broadcast(x, src)
        return x

    return _tree_map(bcast, tree)


# --- placement rules --------------------------------------------------------------------------

def jax_order(module, name, ndim):
    """The port tensor's dims in the JAX package's axis order: (1, 0) for a
    Linear weight, (2, ..., ndim - 1, 1, 0) for a conv weight, the dims as
    they are for every other tensor (and for any tensor outside a module)."""
    if name == 'weight' and isinstance(module, nn.Linear):
        return (1, 0)
    if name == 'weight' and isinstance(module, nn.modules.conv._ConvNd):
        return (*range(2, ndim), 1, 0)
    return tuple(range(ndim))


def _leaves(params):
    """(name, shape, JAX order) of every tensor of a module (its parameters)
    or of a mapping of names to tensors (taken in their own layout)."""
    if isinstance(params, nn.Module):
        for module_name, module in params.named_modules():
            for name, p in module.named_parameters(recurse=False):
                yield (f'{module_name}.{name}' if module_name else name, tuple(p.shape),
                       jax_order(module, name, p.ndim))
    else:
        for name, x in params.items():
            yield name, tuple(x.shape), tuple(range(len(x.shape)))


def _numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n


def param_sharding_rules(mesh, params, min_weight_size: int = 2 ** 16):
    """{name: placements} for params. With model=1 everything is replicated.
    With model>1, every tensor of two or more dims and at least
    `min_weight_size` elements whose JAX last (out-feature) axis divides by
    `model` is sharded there over 'model' (Megatron columns); the rest is
    replicated."""
    model_size = axis_size(mesh, 'model')
    out = {}
    for name, shape, order in _leaves(params):
        if (model_size > 1 and len(shape) >= 2 and _numel(shape) >= min_weight_size
                and shape[order[-1]] % model_size == 0):
            out[name] = (Replicate(), Shard(order[-1]))
        else:
            out[name] = replicated(mesh)
    return out


def zero_sharding_rules(mesh, tree, min_size: int = 2 ** 15):
    """ZeRO-1 layout: `param_sharding_rules`' placements, and every tensor of
    at least `min_size` elements sharded over 'data' on its biggest free
    axis that divides by `data` (the last such in the JAX order among equal
    sizes), so each rank holds 1/data of it."""
    data = axis_size(mesh, 'data')
    base = param_sharding_rules(mesh, tree)
    if data == 1:
        return base
    out = {}
    for name, shape, order in _leaves(tree):
        data_pl, model_pl = base[name]
        taken = model_pl.dim if isinstance(model_pl, Shard) else None
        cands = [(shape[d], axis) for axis, d in enumerate(order)
                 if d != taken and shape[d] % data == 0]
        if _numel(shape) < min_size or not shape or not cands:
            out[name] = base[name]
            continue
        _, axis = max(cands)
        out[name] = (Shard(order[axis]), model_pl)
    return out


def fsdp_sharding_rules(mesh, params, min_size: int = 2 ** 15):
    """FSDP (ZeRO-3) layout for params: the rule of `zero_sharding_rules`,
    applied to the weights (and so to their moments and EMA, which share
    their shapes)."""
    return zero_sharding_rules(mesh, params, min_size)


def local_shard(mesh, full: torch.Tensor, placements) -> torch.Tensor:
    """This rank's block of `full` under `placements` (even splits)."""
    out = full
    for axis, placement in zip(AXES, placements):
        if isinstance(placement, Shard):
            n, i = axis_size(mesh, axis), mesh.get_local_rank(axis)
            size = out.shape[placement.dim] // n
            out = out.narrow(placement.dim, i * size, size)
    return out


def _named_tensors(params):
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _place(mesh, params, specs):
    device = mesh_device(mesh)
    return {name: DTensor.from_local(
                local_shard(mesh, x.detach().to(device), specs[name]).contiguous(), mesh,
                specs[name], run_check=False, shape=x.shape, stride=x.contiguous().stride())
            for name, x in _named_tensors(params).items()}


def shard_params(mesh, params, min_weight_size: int = 2 ** 16):
    """{name: DTensor} of params placed by `param_sharding_rules`; every rank
    passes the full values."""
    return _place(mesh, params, param_sharding_rules(mesh, params, min_weight_size))


def shard_opt_state(mesh, tree, min_size: int = 2 ** 15):
    """{name: DTensor} of a name -> tensor mapping in the ZeRO-1 layout."""
    return _place(mesh, tree, zero_sharding_rules(mesh, tree, min_size))


def shard_params_fsdp(mesh, params, min_size: int = 2 ** 15):
    """{name: DTensor} of params in the FSDP (ZeRO-3) layout."""
    return _place(mesh, params, fsdp_sharding_rules(mesh, params, min_size))


def host_offload(tree):
    """A module, or a tree of tensors, moved to host memory (the cascade's
    stages that are not in use, say); `device_restore` brings it back."""
    if isinstance(tree, nn.Module):
        return tree.to('cpu')
    return _tree_map(lambda x: x.to('cpu') if isinstance(x, torch.Tensor) else x, tree)


def device_restore(tree, device=None):
    """A host-parked module or tensor tree back on `device` (None: the card)."""
    device = resolve_device(device)
    if isinstance(tree, nn.Module):
        return tree.to(device)
    return _tree_map(lambda x: x.to(device) if isinstance(x, torch.Tensor) else x, tree)
