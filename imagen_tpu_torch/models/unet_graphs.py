"""CUDA graphs of a U-Net's inference forward, shared by `Unet` and `Unet3D`.

A U-Net forward is some 3,000 kernel launches, each issued from Python
through the dispatcher; at a small batch the host takes several times the
device's time to issue them. `ForwardGraphs` captures the forward once into
a `torch.cuda.CUDAGraph` for each input signature and replays it, so the
host issues one graph launch instead. The graph holds the same kernels on
the same inputs: every hand-written kernel keeps its route.

The route is decided by what the call can see. A graph is replayed only
when no gradient is recorded, the U-Net is in eval mode, every input tensor
and every parameter and buffer is a plain tensor on one CUDA device (no
DTensor), nothing draws from `generator` (`cond_drop_prob` 0 or a
`force_text_drop_mask` given), no torch profiler and no torch function or
dispatch mode (a FLOP counter, say) is on, and no submodule carries a
forward hook or pre-hook and no global module hook is set: a replay would
skip them all. Hooks on the U-Net itself run outside its forward. Every
other call runs eagerly, as does code that switches a kernel's gate between
calls unless it keeps the forwards off the route (a global hook will do).

A signature is the tensor inputs' names, shapes and dtypes (absent ones
too), the other inputs (hashable, or the call runs eagerly) and the compute
dtype. Its first call runs eagerly and makes every lazy initialisation
(kernel build, tensor-map caches, kept bf16 weights, library handles); the
second copies the inputs into static buffers, captures and replays; later
calls copy and replay. Each call returns a clone of the static output. A
stamp of every parameter and buffer (identity, `_version`, `data_ptr`, as
`blocks.KeepsPacked` stamps them) drops the graphs when it changes: an EMA
update, `load_state_dict`, an optimiser step, replaced parameters; `.to()`
drops them too. At most `CAP` signatures are kept, the least recently used
dropped first; the graphs of one U-Net share a memory pool.

Each forward is counted as `unet_graph` by route (`capture`, `replay`,
`eager`), key (class name, input shape), work its rows; a replay counts
again the route counters its capture made, and its kernel launches apart,
in `ops._build.REPLAYED` (`utils.profiling.taping`), so a recording still
says what ran.
"""
from __future__ import annotations

import warnings
from collections import OrderedDict

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.nn.modules import module as _module

from imagen_tpu_torch.utils.profiling import count, taping

CAP = 4
DEVICE_TYPE = 'cuda'
_PLAIN = (torch.Tensor, torch.nn.Parameter)
_SEEN = 'seen'       # a signature called once, eagerly
_EAGER = 'eager'     # a signature whose capture failed: eager from then on


class CudaGraph:
    """`fn()` captured into a `torch.cuda.CUDAGraph` on `device`, in `pool`
    (None: a new one); `output` is what the capture returned, which each
    `replay` writes again."""

    def __init__(self, fn, device, pool=None):
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device), torch.cuda.graph(
                self.graph, pool=pool, capture_error_mode='thread_local'):
            self.output = fn()
        self.pool = self.graph.pool()

    def replay(self):
        self.graph.replay()


Graph = CudaGraph   # what captures; the CPU tests put a stand-in in its place


class _Entry:
    __slots__ = ('graph', 'static', 'tape')

    def __init__(self, graph, static, tape):
        self.graph, self.static, self.tape = graph, static, tape


def _stamp(unet):
    """Every parameter's and buffer's (id, version, data pointer), or None
    where a submodule carries a forward hook or a tensor is not plain."""
    out, stack = [], [unet]
    while stack:
        m = stack.pop()
        if m is not unet and (m._forward_hooks or m._forward_pre_hooks):
            return None
        for tensors in (m._parameters, m._buffers):
            for t in tensors.values():
                if t is not None:
                    if type(t) not in _PLAIN:
                        return None
                    out.append((id(t), t._version, t.data_ptr()))
        stack.extend(c for c in m._modules.values() if c is not None)
    return out


def _device_of(unet):
    """The one device of every parameter and buffer, or None."""
    devices = {t.device for t in (*unet.parameters(), *unet.buffers())}
    return devices.pop() if len(devices) == 1 else None


class ForwardGraphs:
    """The captured forwards of one U-Net (see the module docstring). A copy
    or a pickle of it is empty."""

    def __init__(self):
        self.entries = OrderedDict()   # signature -> _SEEN, _EAGER or an _Entry
        self._stamp, self._device, self._pool = None, None, None

    def __reduce__(self):
        return type(self), ()

    def clear(self):
        self.entries.clear()
        self._stamp, self._device, self._pool = None, None, None

    def _signature(self, unet, inputs):
        """The call's signature, or None where the graph route does not apply."""
        if (torch.is_grad_enabled() or unet.training
                or _autograd_profiler._is_profiler_enabled
                or torch._C._len_torch_function_stack() or torch._C._len_torch_dispatch_stack()
                or _module._global_forward_hooks or _module._global_forward_pre_hooks):
            return None
        if inputs['cond_drop_prob'] != 0 and inputs['force_text_drop_mask'] is None:
            return None
        device, key = None, [unet.dtype]
        for name, v in inputs.items():
            if isinstance(v, torch.Tensor):
                if type(v) is not torch.Tensor or v.device.type != DEVICE_TYPE or (
                        device is not None and v.device != device):
                    return None
                device = v.device
                key.append((name, tuple(v.shape), v.dtype))
            else:
                try:
                    hash(v)
                except TypeError:
                    return None
                key.append((name, v))
        stamp = _stamp(unet)
        if stamp is None:
            return None
        if stamp != self._stamp:
            self.clear()
            self._stamp, self._device = stamp, _device_of(unet)
        if device != self._device:
            return None
        return tuple(key)

    def _keep(self, signature, value):
        self.entries[signature] = value
        self.entries.move_to_end(signature)
        while len(self.entries) > CAP:
            self.entries.popitem(last=False)

    def _capture(self, run, inputs):
        """The entry of a new graph of `run` on static copies of `inputs`, or
        None where the capture fails."""
        static = {k: v.clone(memory_format=torch.contiguous_format)
                  for k, v in inputs.items() if isinstance(v, torch.Tensor)}
        args = {**inputs, **static}
        try:
            with taping() as tape:
                graph = Graph(lambda: run(**args), self._device, self._pool)
        except RuntimeError as err:
            warnings.warn(f'the U-Net forward could not be captured into a CUDA graph and '
                          f'runs eagerly at this signature: {err}')
            return None
        self._pool = graph.pool
        return _Entry(graph, static, tape)

    def _route(self, unet, run, inputs):
        """(the entry to replay, 'capture' or 'replay'), or (None, 'eager')."""
        signature = self._signature(unet, inputs)
        if signature is None:
            return None, 'eager'
        entry = self.entries.get(signature)
        if entry is None:
            self._keep(signature, _SEEN)
            return None, 'eager'
        if entry is _SEEN:
            entry = self._capture(run, inputs)
            self._keep(signature, _EAGER if entry is None else entry)
            return entry, 'eager' if entry is None else 'capture'
        self.entries.move_to_end(signature)
        if entry is _EAGER:
            return None, 'eager'
        for k, buf in entry.static.items():
            buf.copy_(inputs[k])
        return entry, 'replay'

    def __call__(self, unet, run, *, generator=None, **inputs):
        """`run(**inputs, generator=generator)`, or its replay."""
        entry, route = self._route(unet, run, inputs)
        x = inputs['x']
        count('unet_graph', route, (type(unet).__name__, tuple(x.shape)), x.shape[0])
        if entry is None:
            return run(**inputs, generator=generator)
        entry.graph.replay()
        entry.tape.replay()
        return entry.graph.output.clone()
