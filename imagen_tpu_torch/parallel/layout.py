"""One unet's training state on a mesh: the port's counterpart of GSPMD
placing the JAX trainer's state by `_placement_specs`.

A tensor's placement is a tuple of `Split(dim, axis)`: the mesh axes it is
cut over and the dim each cuts (`splits_of` reads them off DTensor
placements). A rank holds one even block of it.

- Sharded parameters (FSDP over 'data', columns over 'model'): the module
  keeps only its block of each, as the parameter the optimiser updates.
  Forward pre-hooks on its blocks (the first modules under the root that
  are not containers, `_blocks_of`, and the root for its own tensors) gather each block's
  weights before its forward; the gathered tensor is a function of the
  block (`_Gather`), whose backward reduce-scatters the gradient over
  'data' (the mean of the ranks' rows) and keeps this rank's columns of
  'model' (whose ranks compute on the same rows). Without a gradient (a
  sample, a validation loss) the block goes back after the forward. With
  one, the full weights are freed after the block's forward (their storage
  emptied, as ZeRO-3 reshards), gathered again into the same storage when
  the gradient reaches the block's outputs, and freed again once their own
  gradient is complete (`_Gather`'s backward): a rank holds a block's full
  weights only during its forward and its backward, and a remat recompute
  inside the block reads them there. `release`, after the backward, puts
  the blocks back in the module.
- Every other gradient is a mean over 'data' after the last backward, in
  one all-reduce (`reduce_grads`), which the accumulation chunks before
  never wait for; one replicated over 'model' is averaged there too, so the
  ranks' copies stay equal bit for bit.
- ZeRO-1: a tensor whose optimiser placement cuts 'data' where its
  parameter's does not is updated as a block of its own (`optimizer_tensors`),
  copied from the parameter, whose gradient is that block of the averaged
  gradient; after the step the blocks are gathered back into the parameter
  (`after_step`).
- Norms and Adafactor's factored means over a cut dim are sums of the
  ranks' partial sums (`global_norms`, `sum`).
- Checkpoints: `full_state_dict` / `full_optimizer_state` gather every
  block (a collective: every rank calls it), `local_state_dict` /
  `local_optimizer_state` keep this rank's blocks of full values, and
  `module_dtensors` / `optimizer_dtensors` wrap the blocks as DTensors for
  a sharded checkpoint.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from imagen_tpu_torch.parallel.mesh import AXES, axis_size


class Split(NamedTuple):
    dim: int
    axis: str


def splits_of(placements):
    """The `Split`s of DTensor placements over ('data', 'model')."""
    return tuple(Split(p.dim, axis) for axis, p in zip(AXES, placements) if isinstance(p, Shard))


def placements_of(splits):
    """DTensor placements over ('data', 'model') of `Split`s."""
    cut = {s.axis: Shard(s.dim) for s in splits}
    return tuple(cut.get(axis, Replicate()) for axis in AXES)


class MeshComm:
    """The collectives of a ('data', 'model') mesh on blocks of tensors."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.size = {axis: axis_size(mesh, axis) for axis in AXES}
        self.coord = {axis: mesh.get_local_rank(axis) for axis in AXES}
        self.group = {axis: mesh.get_group(axis) for axis in AXES}

    def block(self, full, splits):
        """This rank's block of `full`."""
        out = full
        for s in splits:
            size = out.shape[s.dim] // self.size[s.axis]
            out = out.narrow(s.dim, self.coord[s.axis] * size, size)
        return out

    def gather(self, local, splits):
        """The full tensor from every rank's block (all ranks call it)."""
        out = local
        for s in splits:
            x = out.movedim(s.dim, 0).contiguous()
            buf = x.new_empty((self.size[s.axis] * x.shape[0], *x.shape[1:]))
            dist.all_gather_into_tensor(buf, x, group=self.group[s.axis])
            out = buf.movedim(0, s.dim)
        return out.contiguous()

    def sum(self, x, axes):
        """x summed in place over the ranks of each of `axes`."""
        for axis in axes:
            if self.size[axis] > 1:
                dist.all_reduce(x, group=self.group[axis])
        return x

    def grad_block(self, grad, splits):
        """This rank's block of the gradient of a gathered tensor: its own
        columns of 'model' and, over 'data', the mean of the ranks' blocks."""
        for s in splits:
            if s.axis == 'model':
                size = grad.shape[s.dim] // self.size['model']
                grad = grad.narrow(s.dim, self.coord['model'] * size, size)
        for s in splits:
            if s.axis == 'data':
                x = grad.movedim(s.dim, 0).contiguous()
                out = x.new_empty((x.shape[0] // self.size['data'], *x.shape[1:]))
                dist.reduce_scatter_tensor(out, x, group=self.group['data'])
                grad = out.div_(self.size['data']).movedim(0, s.dim)
        return grad.contiguous()


class _Gather(torch.autograd.Function):
    """The full tensor of a block; its gradient is the block of the
    gradient (`MeshComm.grad_block`). The full tensor's storage is emptied
    then: every use of it has had its backward."""

    @staticmethod
    def forward(ctx, local, comm, splits):
        ctx.comm, ctx.splits = comm, splits
        full = comm.gather(local, splits)
        ctx.save_for_backward(full)
        return full

    @staticmethod
    def backward(ctx, grad):
        full, = ctx.saved_tensors
        _free(full)
        return ctx.comm.grad_block(grad, ctx.splits), None, None


def _free(t):
    t.untyped_storage().resize_(0)


@torch.no_grad()
def _refill(t, full):
    """Put `full`'s values back into the emptied storage of `t` (contiguous,
    as a gather makes it). The storage is written under `t`, whose version
    does not change, so the backward still takes it as saved."""
    storage = t.untyped_storage()
    storage.resize_(full.untyped_storage().nbytes())
    storage.copy_(full.untyped_storage())


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _blocks_of(module):
    """The modules whose forward pre-hooks gather weights: the first modules
    under `module` that are not containers (ModuleList, ModuleDict, a plain
    Sequential, whose items a parent may call one by one). A subclass of
    Sequential with a forward of its own (`FeedForward`, which hands its
    items' weights to one kernel) is a block."""
    for child in module.children():
        if isinstance(child, (nn.ModuleList, nn.ModuleDict)) or type(child) is nn.Sequential:
            yield from _blocks_of(child)
        else:
            yield child


class _Entry(NamedTuple):
    owner: nn.Module
    name: str
    block: nn.Parameter
    splits: tuple


class UnetLayout:
    """Where one unet's parameters and optimiser state live on `comm`'s
    mesh. `param_splits` and `opt_splits` map the unet's parameter names to
    their `Split`s (the trainer's placement function decides them);
    `shard` applies the parameters' to a module (the unet and its EMA copy
    alike)."""

    def __init__(self, comm, param_splits, opt_splits):
        self.comm = comm
        self.param_splits = param_splits
        self.opt_splits = opt_splits
        self.info = {}         # tensor -> (full shape, splits), for every block
        self._entries = {}     # id(module) -> [_Entry]
        self._slices = []      # ZeRO-1: (parameter, block, Split)

    # --- parameters -----------------------------------------------------------------------

    def shard(self, module):
        """Keep only this rank's block of each cut parameter of `module`, and
        gather them before the forward of the block of the module that holds
        them (see the module docstring). Returns the module."""
        entries = []
        module_names = {id(m): n for n, m in module.named_modules()}
        for block in (module, *_blocks_of(module)):
            block_entries = []
            owners = [module] if block is module else list(block.modules())
            for owner in owners:
                prefix = module_names[id(owner)]
                for name, p in list(owner._parameters.items()):
                    splits = self.param_splits.get(f'{prefix}.{name}' if prefix else name, ())
                    if p is None or not splits:
                        continue
                    local = nn.Parameter(self.comm.block(p.detach(), splits).clone(),
                                         requires_grad=p.requires_grad)
                    owner._parameters[name] = local
                    self.info[local] = (tuple(p.shape), splits)
                    block_entries.append(_Entry(owner, name, local, splits))
            if block_entries:
                block.register_forward_pre_hook(self._gather_hook(block_entries))
                block.register_forward_hook(self._reshard_hook(block_entries), always_call=True)
                entries += block_entries
        self._entries[id(module)] = entries
        return module

    def _gather_hook(self, entries):
        comm = self.comm

        def hook(module, args):
            for e in entries:
                e.owner._parameters[e.name] = _Gather.apply(e.block, comm, e.splits)
        return hook

    def _reshard_hook(self, entries):
        """After the block's forward: without a gradient, the blocks back in
        place; with one, the full weights' storage emptied and gathered again
        when the gradient reaches the block's outputs. A block's forward runs
        outside the backward pass: remat recomputes inside blocks (from the
        weights gathered again), never a whole block."""
        comm = self.comm

        def hook(module, args, output):
            outputs = [t for t in _tensors(output) if t.requires_grad]
            if not (torch.is_grad_enabled() and outputs):
                for e in entries:
                    e.owner._parameters[e.name] = e.block
                return
            full = [e.owner._parameters[e.name] for e in entries]
            for t in full:
                _free(t)
            gathered = []

            def regather(grad):
                if not gathered:
                    gathered.append(True)
                    for e, t in zip(entries, full):
                        _refill(t, comm.gather(e.block.detach(), e.splits))

            for t in outputs:
                t.register_hook(regather)
        return hook

    def release(self, module):
        """Put the blocks back in place of the weights gathered for a forward
        with gradient (after its backward; their storage is empty by then)."""
        for e in self._entries.get(id(module), ()):
            e.owner._parameters[e.name] = e.block

    # --- gradients and the update ---------------------------------------------------------

    def reduce_grads(self, params):
        """Average the gradients that the backward did not reduce: over 'data'
        those of tensors not cut there, over 'model' those of tensors not cut
        there; one all-reduce per axis."""
        for axis in AXES:
            n = self.comm.size[axis]
            grads = [p.grad for p in params if axis not in self._axes(p)]
            if n == 1:
                continue
            for bucket in _buckets(grads):
                flat = torch.cat([g.reshape(-1) for g in bucket])
                self.comm.sum(flat, (axis,)).div_(n)
                torch._foreach_copy_(bucket, [v.view_as(g) for v, g in
                                              zip(flat.split([g.numel() for g in bucket]), bucket)])

    def _axes(self, t):
        """The mesh axes that cut tensor `t` (none for a tensor held whole)."""
        return {s.axis for s in self.info[t][1]} if t in self.info else set()

    def full_shape(self, t):
        info = self.info.get(t)
        return None if info is None else info[0]

    def sum(self, x, t, dims):
        """x, a partial sum over `dims` of block `t`, summed over the ranks
        that cut those dims of `t`."""
        axes = [s.axis for s in self.info[t][1] if s.dim in dims]
        return self.comm.sum(x, axes)

    def global_norms(self, tensors, norms):
        """The norms of the full tensors from `norms`, a vector of the norms
        of this rank's blocks of `tensors` (those of uncut tensors kept as
        they are)."""
        sq, any_cut = norms * norms, torch.zeros_like(norms, dtype=torch.bool)
        for axis in AXES:
            cut = torch.tensor([axis in self._axes(t) for t in tensors], device=norms.device)
            if self.comm.size[axis] == 1 or not bool(cut.any()):
                continue
            part = self.comm.sum(torch.where(cut, sq, torch.zeros_like(sq)), (axis,))
            sq, any_cut = torch.where(cut, part, sq), any_cut | cut
        return torch.where(any_cut, sq.sqrt(), norms)

    def optimizer_tensors(self, params, names):
        """The tensors the optimiser updates, one a parameter: the parameter,
        or (ZeRO-1) its block of 'data' where its optimiser placement cuts
        'data' and the parameter does not."""
        out = []
        for p, name in zip(params, names):
            extra = [s for s in self.opt_splits.get(name, ())
                     if s.axis == 'data' and s.axis not in self._axes(p)]
            if not extra:
                out.append(p)
                continue
            split = extra[0]
            block = nn.Parameter(self.comm.block(p.detach(), (split,)).clone())
            full_shape, splits = self.info.get(p, (tuple(p.shape), ()))
            self.info[block] = (full_shape, (*splits, split))
            self._slices.append((p, block, split))
            out.append(block)
        return out

    def before_step(self):
        """ZeRO-1: each block's gradient is its block of the parameter's."""
        for p, block, split in self._slices:
            block.grad = self.comm.block(p.grad, (split,)).contiguous()

    @torch.no_grad()
    def after_step(self):
        """ZeRO-1: the updated blocks gathered back into their parameters."""
        for p, block, split in self._slices:
            p.copy_(self.comm.gather(block.detach(), (split,)))
            p.grad = block.grad = None

    @torch.no_grad()
    def resync(self):
        """ZeRO-1: the blocks taken again from their parameters (after a load)."""
        for p, block, split in self._slices:
            block.copy_(self.comm.block(p.detach(), (split,)))

    # --- checkpoints ----------------------------------------------------------------------

    def full_state_dict(self, module):
        """`module.state_dict()` with every block gathered (collective)."""
        self.release(module)
        return {k: self.comm.gather(v.detach(), self.info[v][1]) if v in self.info
                else v.detach() for k, v in module.state_dict(keep_vars=True).items()}

    def local_state_dict(self, module, full):
        """A full state dict cut to this rank's blocks of `module`."""
        own = module.state_dict(keep_vars=True)
        return {k: self.comm.block(v, self.info[own[k]][1]).contiguous()
                if k in own and own[k] in self.info else v for k, v in full.items()}

    def _state_splits(self, opt, p, key, value):
        """The `Split`s of optimiser state `key` of block `p` (the block or the
        full tensor): those of `p` for a tensor of its rank, none for a
        scalar, and for a statistic with one dim reduced away
        (`opt.reduced_dim`), p's without it."""
        if not isinstance(value, torch.Tensor) or p not in self.info or value.ndim == 0:
            return ()
        full_shape, splits = self.info[p]
        if value.ndim == len(full_shape):
            return splits
        dim = opt.reduced_dim(key, full_shape)
        return tuple(Split(s.dim - (s.dim > dim), s.axis) for s in splits if s.dim != dim)

    def _map_optimizer_state(self, opt, state, fn):
        params = [p for group in opt.param_groups for p in group['params']]
        return {**state, 'state': {
            i: {k: fn(v, self._state_splits(opt, params[i], k, v)) if isinstance(v, torch.Tensor)
                else v for k, v in s.items()}
            for i, s in state['state'].items()}}

    def full_optimizer_state(self, opt):
        """`opt.state_dict()` with every block of state gathered (collective)."""
        return self._map_optimizer_state(
            opt, opt.state_dict(), lambda v, splits: self.comm.gather(v, splits) if splits else v)

    def local_optimizer_state(self, opt, full):
        """A full optimiser state dict cut to this rank's blocks."""
        return self._map_optimizer_state(
            opt, full, lambda v, splits: self.comm.block(v, splits).contiguous())

    def _dtensor(self, local, splits, full_shape):
        return DTensor.from_local(local, self.comm.mesh, placements_of(splits), run_check=False,
                                  shape=full_shape, stride=_contiguous_stride(full_shape))

    def module_dtensors(self, module):
        """`module.state_dict()` with every block a DTensor over the mesh
        (sharing the block's storage): what a sharded checkpoint writes, each
        rank its own blocks, and reads back in place."""
        self.release(module)
        return {k: self._dtensor(v.detach(), *self.info[v][::-1]) if v in self.info
                else v.detach() for k, v in module.state_dict(keep_vars=True).items()}

    def optimizer_dtensors(self, opt):
        """`opt.state_dict()` with every block of state a DTensor (see
        `module_dtensors`)."""
        params = [p for group in opt.param_groups for p in group['params']]

        def wrap(i, key, v):
            splits = self._state_splits(opt, params[i], key, v)
            if not splits:
                return v
            full_shape, _ = self.info[params[i]]
            if v.ndim < len(full_shape):
                dim = opt.reduced_dim(key, full_shape)
                full_shape = full_shape[:dim] + full_shape[dim + 1:]
            return self._dtensor(v, splits, full_shape)

        state = opt.state_dict()
        return {**state, 'state': {i: {k: wrap(i, k, v) if isinstance(v, torch.Tensor) else v
                                       for k, v in s.items()}
                                   for i, s in state['state'].items()}}


def _buckets(tensors, size=2 ** 26):
    """`tensors` in runs of about `size` elements (one all-reduce each)."""
    bucket, n = [], 0
    for t in tensors:
        bucket.append(t)
        n += t.numel()
        if n >= size:
            yield bucket
            bucket, n = [], 0
    if bucket:
        yield bucket


def _contiguous_stride(shape):
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))
