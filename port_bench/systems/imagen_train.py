"""Drives the training step of one U-Net of an `Imagen` cascade of the port.

A mix with `"system": "imagen_train"` trains stage `unet_number` of its
configuration through the product path,
`ImagenTrainer.step_with_batch({'images', 'text_embeds', 'text_masks'},
unet_number=...)`, with no `max_batch_size`, so the whole batch is one pass.
The other stages are `NullUnet`s, as in a job that trains one stage. The
trainer is built as the mix's `train` block states (optimizer, learning
rate, betas, EMA settings; precision from the configuration's
`compute_dtype`), its generator seeded from the run's seed, and the loss
settings of `Imagen` from the mix's `loss` block. A request is one step's
batch: the mix's rows of images in [0, 1], and their text zero-padded to
`max_text_len` with masks false past each prompt, as stored encodings are
served.

The check of `correct` takes two kinds of step:
- the first: set-up drives the trainer from the seed through the mix's
  `checked_steps` steps, with the window's own call and feed, on requests
  -n .. -1; they are the warm-up. It keeps each step's loss and the draws
  made from the trainer's generator (recorded as they are made), the norm of
  each parameter's first gradient as the optimiser gets it (a step pre-hook
  reads `.grad`), and the norm of each parameter's change over the steps,
  against the seeded weights made again. Once the program is freed, the
  plain reference (`port_bench/reference/train.py`) takes the same steps from
  the seeded weights with its own generator;
- the late step: after the window the trainer runs on to the step before
  its next EMA update, and the state the window left (parameters, Adafactor
  state, EMA weights, step count, generator state) is copied to the host.
  The trainer then takes that step, keeping its loss, draws, gradient norms,
  change and EMA weights, and once the program is freed the reference takes
  the same step from the copy. This follows the program's own state, which
  only the program's steps reach; the first steps check the start.
`numbers` compares the two sides.
"""
from __future__ import annotations

import math
import statistics
import sys
from contextlib import nullcontext
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from port_bench import weights
from port_bench.reference import numerics, specs, train as ref, unet_kwargs
from port_bench.reference.unet import Unet as ReferenceUnet
from port_bench.systems.imagen_sample import weights_of

INF = math.inf
# a leaf whose gradient in the reference is below this share of the median
# leaf's moves by round-off alone and is left out of `change`
STILL = 1e-3
# the program's Adafactor state keys, as the reference names them
STATE_KEYS = {'step': 'step', 'v': 'v', 'v_row': 'r', 'v_col': 'c', 'momentum': 'm'}


@dataclass
class System:
    imagen: object
    unets: list              # the trained U-Net alone
    mix: dict
    config: dict
    index: int               # the trained stage
    trainer: object = None
    seed: int = None
    targets: dict = field(default_factory=dict)   # what the per-layer readers' spans wrap
    found: dict = field(default_factory=dict)     # the program's readings for the check


def build(config, mix, device):
    """The cascade with the trained stage's U-Net and NullUnets elsewhere;
    the trainer comes with the weights (`load_weights`)."""
    import imagen_tpu_torch as it
    index = mix['unet_number'] - 1
    if index != 0 or config['noise_schedules'] != 'cosine':
        raise ValueError('the reference trains a first stage under the cosine schedule')
    dtype = getattr(torch, config['compute_dtype'])
    unets = []
    for i, spec in enumerate(config['unets']):
        if i != index:
            unets.append(it.NullUnet(lowres_cond=i > 0, device=device))
            continue
        kwargs = {k: tuple(v) if isinstance(v, list) else v for k, v in spec.items() if k != 'unet'}
        unets.append(it.Unet(**kwargs, text_embed_dim=config['text_embed_dim'],
                             max_text_len=config['max_text_len'], lowres_cond=False,
                             dtype=dtype, device=device))
    loss = mix['loss']
    imagen = it.Imagen(
        unets, image_sizes=tuple(config['image_sizes']), timesteps=tuple(config['timesteps']),
        text_embed_dim=config['text_embed_dim'], cond_drop_prob=config['cond_drop_prob'],
        noise_schedules=config['noise_schedules'],
        lowres_noise_schedule=config['lowres_noise_schedule'], loss_type=loss['type'],
        pred_objectives=loss['objective'], min_snr_loss_weight=True,
        min_snr_gamma=loss['min_snr_gamma'], device=device)
    stated = getattr(torch, config['param_dtype'])
    if any(p.dtype != stated for p in imagen.parameters()):
        raise ValueError(f'the cascade does not hold its weights in {stated}')
    return System(imagen, [imagen.unets[index]], mix, config, index)


def load_weights(system, seed, device):
    """The seeded weights into the trained U-Net, then a fresh trainer whose
    state (optimizer, EMA copy, step count) starts from them."""
    from imagen_tpu_torch import ImagenTrainer
    index, config = system.index, system.config
    system.unets[0].load_state_dict(weights_of(seed, device)(index, specs(config, index)),
                                    strict=True)
    train = system.mix['train']
    system.trainer = ImagenTrainer(
        system.imagen, optimizer=train['optimizer'], lr=train['lr'], beta1=train['beta1'],
        beta2=train['beta2'], max_grad_norm=None, weight_decay=0., warmup_steps=None,
        use_ema=True, only_train_unet_number=index + 1,
        precision='bf16' if config['compute_dtype'] == 'bfloat16' else None,
        seed=weights.derive(seed, 'train'), verbose=False,
        **{f'ema_{k}': v for k, v in train.get('ema', {}).items()})
    system.trainer.prepare()
    system.seed = seed
    system.targets = dict(trainer=system.trainer, optimizer=system.trainer.optimizers[index],
                          trainer_module=sys.modules[type(system.trainer).__module__])


def batch_of(config, request):
    """A request as the trainer's batch: text zero-padded to `max_text_len`."""
    embeds, masks = request['text_embeds'], request['text_masks']
    pad = config['max_text_len'] - embeds.shape[1]
    return dict(images=request['start_image'], text_embeds=F.pad(embeds, (0, 0, 0, pad)),
                text_masks=F.pad(masks, (0, pad), value=False))


def step(system, request):
    """One optimiser step on `request`; a loss that is not finite raises."""
    loss = system.trainer.step_with_batch(batch_of(system.config, request),
                                          unet_number=system.index + 1)
    if not math.isfinite(loss):
        raise FloatingPointError(f'the step returned the loss {loss}')
    return loss


class Draws(TorchFunctionMode):
    """Keeps, in order, what every call given `generator` returns."""

    def __init__(self, generator):
        super().__init__()
        self.generator, self.taken = generator, []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if kwargs.get('generator') is self.generator:
            self.taken.append(out.detach().float().cpu())
        return out


class Grads:
    """{name: norm} of each parameter's gradient as `optimizer` gets it on
    its first step while open (a step pre-hook)."""

    def __init__(self, optimizer, unet):
        self.optimizer, self.named, self.norms = optimizer, list(unet.named_parameters()), None

    def __enter__(self):
        self.handle = self.optimizer.register_step_pre_hook(self._read)
        return self

    def _read(self, optimizer, args, kwargs):
        if self.norms is None:
            self.norms = _norms({n: p.grad for n, p in self.named})

    def __exit__(self, *exc):
        self.handle.remove()


def _norms(tensors):
    """{name: norm in float64} of `tensors`, read back in one transfer."""
    values = torch.stack([torch.linalg.vector_norm(t, dtype=torch.float64)
                          for t in tensors.values()])
    return dict(zip(tensors, values.tolist()))


def _checked_step(system, request, grads=True):
    """One step, with its loss, its draws and, with `grads`, the norms of the
    gradients it took."""
    trainer = system.trainer
    with Draws(trainer.generator) as drawn, (
            Grads(trainer.optimizers[system.index], system.unets[0]) if grads
            else nullcontext()) as taken:
        loss = step(system, request)
    return loss, drawn.taken, taken.norms if grads else None


def warm_up(system, request_of):
    """The checked first steps on requests -n .. -1, which are the warm-up
    (see the module's doc)."""
    n = system.mix['checked_steps']
    losses, taken, grads = [], [], None
    for k in range(n):
        loss, drawn, norms = _checked_step(system, request_of(k - n), grads=k == 0)
        losses.append(loss)
        taken.append(drawn)
        grads = grads or norms
    unet = system.unets[0]
    device = next(unet.parameters()).device
    start = weights_of(system.seed, device)(system.index, specs(system.config, system.index))
    change = _norms({name: p.detach() - start[name] for name, p in unet.named_parameters()})
    system.found = dict(first=dict(losses=losses, draws=taken, grads=grads, change=change))


def checked(seed, mix):
    """The window keeps no answers: the checked steps are set-up's and the late one."""
    return []


def serve(system, request, states=None):
    """One step; returns the batch's images, whose first dim counts the rows trained."""
    step(system, request)
    return request['start_image']


def ema_settings(mix):
    return mix['train'].get('ema', {})


def ema_due(mix, after):
    """The first optimiser step after step `after` that updates the EMA with
    a decay above 0."""
    due = after + 1
    while not ref.ema_decay(due, **ema_settings(mix)):
        due += 1
    return due


def settle(system, request_of, index):
    """After the window: steps on request `index` and after up to the step
    before the next EMA update with a decay above 0, then that step as the
    late checked one (`late_step`). Returns the index of the next request."""
    i = system.index
    due = ema_due(system.mix, int(system.trainer.steps[i]))
    while int(system.trainer.steps[i]) < due - 1:
        step(system, request_of(index))
        index += 1
    system.found['late'] = dict(late_step(system, request_of(index)), at=index)
    return index + 1


def late_step(system, request):
    """The next step, from a copy on the host of the state it starts from:
    its loss, draws, gradient norms and change, that copy (`start`) and the
    EMA weights after it (`ema`), by parameter name."""
    trainer, unet, i = system.trainer, system.unets[0], system.index
    opt, ema = trainer.optimizers[i], trainer.ema_unets[i]
    named = list(unet.named_parameters())
    before = {n: p.detach().clone() for n, p in named}
    start = dict(step=int(trainer.steps[i]), generator=trainer.generator.get_state(),
                 ema={n: _host(e) for (n, _), e in zip(named, ema.parameters())},
                 optimizer={n: {k: _host(v) if torch.is_tensor(v) else v
                                for k, v in opt.state[p].items()} for n, p in named})
    loss, drawn, grads = _checked_step(system, request)
    change = _norms({n: p.detach() - before[n] for n, p in named})
    start['params'] = {n: _host(b) for n, b in before.items()}
    del before
    after = {n: _host(e) for (n, _), e in zip(named, ema.parameters())}
    return dict(losses=[loss], draws=[drawn], grads=grads, change=change, start=start, ema=after)


def _host(t):
    """A copy of `t` on the host, which later steps leave as it is."""
    return t.detach().to('cpu', copy=True)


def findings(system, check, kept):
    """What the check needs of the program once it is freed."""
    return system.found


def reference_unet(config, index, state, device):
    """The reference U-Net of stage `index` holding `state` (by name; copied),
    float32, TF32 off."""
    numerics.no_tf32()
    with torch.device('meta'):
        unet = ReferenceUnet(**unet_kwargs(config, index))
    unet.load_state_dict({k: v.to(device, torch.float32, copy=True) for k, v in state.items()},
                         strict=True, assign=True)
    return unet.to(device).train()


def _train(config, mix, unet, requests, gen, state=None, used=None):
    train = mix['train']
    return ref.train(unet, [batch_of(config, r) for r in requests], gen, lr=train['lr'],
                     decay_rate=train['beta2'], momentum=train['beta1'],
                     cond_drop_prob=config['cond_drop_prob'],
                     min_snr_gamma=mix['loss']['min_snr_gamma'], rows=mix['reference_rows'],
                     state=state, used=used)


def follow(config, mix, seed, device, requests, used=None):
    """The reference's first steps from the seeded weights, with its own
    generator, on `requests` (`used`: see `ref.train`)."""
    index = mix['unet_number'] - 1
    unet = reference_unet(config, index, weights_of(seed, device)(index, specs(config, index)),
                          device)
    gen = torch.Generator(device=device).manual_seed(weights.derive(seed, 'train'))
    return _train(config, mix, unet, requests, gen, used=used)


def reference_state(program, unet, device):
    """The program's Adafactor state `program` (by name) as the reference
    keeps it; None where a tensor's state is not what the reference's
    Adafactor keeps for its shape."""
    out = {}
    for name, p in unet.named_parameters():
        factored = ref.factored_dims(p.shape) is not None
        want = {'step', 'momentum'} | ({'v_row', 'v_col'} if factored else {'v'})
        if set(program.get(name, {})) != want:
            return None
        out[name] = {STATE_KEYS[k]: v.to(device, copy=True) if torch.is_tensor(v) else v
                     for k, v in program[name].items()}
    return out


def follow_late(config, mix, device, start, request, ema=None, used=None):
    """The reference's step from the program's state `start` (see
    `late_step`) on `request`, drawing from the program's generator state;
    with the program's EMA weights after it (`ema`), also `ema`, the largest
    gap to the reference's EMA update, and `ema_unchanged`, that of the EMA
    before the step. None where the program's state cannot be followed."""
    unet = reference_unet(config, mix['unet_number'] - 1, start['params'], device)
    state = reference_state(start['optimizer'], unet, device)
    if state is None:
        return None
    gen = torch.Generator(device=device)
    gen.set_state(start['generator'])
    out = _train(config, mix, unet, [request], gen, state=state, used=used)
    if ema is not None:
        decay = ref.ema_decay(start['step'] + 1, **ema_settings(mix))
        gaps, unchanged = [], []
        for name, p in unet.named_parameters():
            before = start['ema'][name].to(device)
            want = ref.ema_update(before, p.detach(), decay)
            gaps.append((ema[name].to(device).float() - want).abs().max().item())
            unchanged.append((before.float() - want).abs().max().item())
        out.update(ema=_largest(gaps), ema_unchanged=_largest(unchanged))
    return out


def reference(config, mix, seed, device, request_of, found):
    """The reference's readings of the first steps and of the late one."""
    n = mix['checked_steps']
    first = follow(config, mix, seed, device, [request_of(k - n) for k in range(n)])
    late = found.get('late')
    if late is not None:
        late = follow_late(config, mix, device, late['start'], request_of(late['at']),
                           ema=late['ema'])
    return dict(first=first, late=late)


def judge(config, mix, seed, device, request_of, found):
    """The compared numbers, in a list of one reading."""
    return [numbers(found, reference(config, mix, seed, device, request_of, found))]


def _largest(values):
    """The largest of `values`; INF where one is not finite or there is none."""
    values = list(values)
    return max(values) if values and all(math.isfinite(v) for v in values) else INF


def _draws_gap(ours, theirs):
    if len(ours) != len(theirs):
        return INF
    gaps = []
    for a, b in zip(ours, theirs):
        if len(a) != len(b) or any(x.shape != y.shape for x, y in zip(a, b)):
            return INF
        gaps += [(x.float().cpu() - y.float().cpu()).abs().max().item() for x, y in zip(a, b)]
    return _largest(gaps)


def _leaf_gaps(ours, theirs, leaves, floor):
    """The gaps of norms over `leaves`, each against the larger of the
    reference's norm of that leaf and `floor` (the median leaf's); None
    where the program lacks a leaf."""
    if ours is None or any(k not in ours for k in leaves):
        return None
    return [abs(ours[k] - theirs[k]) / max(theirs[k], floor) for k in leaves]


def _worst(gaps):
    return INF if gaps is None else _largest(gaps)


def _median(gaps):
    return INF if gaps is None or not all(map(math.isfinite, gaps)) else statistics.median(gaps)


def _step_numbers(ours, theirs):
    """`draws`, `loss`, `grad`, `grad_median` and `change` of one kind of
    step (see `numbers`)."""
    if ours is None or theirs is None:
        return dict(draws=INF, loss=INF, grad=INF, grad_median=INF, change=INF)
    loss = (_largest(abs(a - b) / abs(b) for a, b in zip(ours['losses'], theirs['losses']))
            if len(ours['losses']) == len(theirs['losses']) else INF)
    grads = theirs['grads']
    floor = statistics.median(grads.values())
    moved = [k for k, v in grads.items() if v >= STILL * floor]
    change_floor = statistics.median(theirs['change'][k] for k in moved)
    grad_gaps = _leaf_gaps(ours['grads'], grads, list(grads), floor)
    return dict(draws=_draws_gap(ours['draws'], theirs['draws']), loss=loss,
                grad=_worst(grad_gaps), grad_median=_median(grad_gaps),
                change=_worst(_leaf_gaps(ours['change'], theirs['change'], moved,
                                         change_floor)))


def numbers(found, theirs):
    """The compared numbers of the program's readings `found` against the
    reference's `theirs` (what `reference` returns), for the first steps and
    for the late one (`late_...`):
    - `draws`: the largest difference of a draw, over both (exact);
    - `loss`: the largest relative difference of a step's loss;
    - `grad`: the worst leaf's gap between the norms of the first step's
      gradient; `late_grad_median`: the median leaf's gap in the late step,
      whose worst leaf (`late_grad_worst`) swings with the stated bf16's
      rounding of a gradient that has become small;
    - `change`: the worst leaf's gap between the norms of the change over the
      steps, leaves still to round-off in the reference left out;
    - `ema`: the largest difference of an EMA weight after the late step's
      update from the reference's update of the program's EMA before it."""
    first = _step_numbers(found.get('first'), theirs['first'])
    late = _step_numbers(found.get('late'), theirs['late'])
    first.pop('grad_median')
    late['grad_worst'] = late.pop('grad')
    out = dict(draws=max(first.pop('draws'), late.pop('draws')), **first,
               **{f'late_{k}': v for k, v in late.items()})
    out['ema'] = INF if theirs['late'] is None else theirs['late'].get('ema', INF)
    return out
