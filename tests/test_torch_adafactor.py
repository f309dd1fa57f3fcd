"""The port's Adafactor (`imagen_tpu_torch.optim.Adafactor`, built by
`ImagenTrainer(optimizer='adafactor')`) against the JAX trainer's optax chain.

A tiny unet whose text width and cond width are 128, so that it holds a
square 128 x 128 weight (`text_to_cond`, a Dense (I, O) in JAX and a
Linear (O, I) in the port: the factored axes lie the other way round),
factored non-square weights (the Perceiver's 512 x 128), unfactored
convolutions and vectors. Four updates with clipping, masked weight decay,
warmup and cosine, the same seeded gradients on both sides, saved and
loaded through `ImagenTrainer.save`/`load` after the second: every
parameter to 1e-6 with the momentum in fp32 on both sides, and with the
trainers' bf16 momentum every element but the few whose bf16 momentum
rounded differently in the two packages (those to 1e-5). Then the state
itself (bf16 momentum, the factored pair or the full second moment, by the
optax shapes), the symmetry of the
factored update in its two axes, and what the trainer accepts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_bridge import load_into, max_abs, randn, random_params, rng, t

from imagen_tpu.diffusion.imagen import Imagen as JImagen
from imagen_tpu.models.unet2d import Unet as JUnet
from imagen_tpu.trainer import ImagenTrainer as JTrainer

import imagen_tpu_torch as it
from imagen_tpu_torch.optim import Adafactor, factored_dims
from imagen_tpu_torch.utils.port_weights import state_dict_from_jax

CPU = 'cpu'
WIDE = dict(dim=8, dim_mults=(1, 2), text_embed_dim=128, cond_dim=128, attn_dim_head=4,
            attn_heads=2, attn_pool_num_latents=2, max_text_len=8, layer_attns=False,
            layer_cross_attns=(False, True))
OPT = dict(lr=3e-3, max_grad_norm=0.5, weight_decay=0.1, warmup_steps=2,
           cosine_decay_max_steps=5, optimizer='adafactor')
UPDATES, SAVED_AFTER = 4, 2


def _imagens():
    kw = dict(image_sizes=(16,), text_embed_dim=128, timesteps=4)
    jimagen = JImagen(unets=(JUnet(**WIDE),), **kw)
    params = random_params(jimagen.unets[0], jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,)),
                           text_embeds=jnp.zeros((1, 8, 128)),
                           text_mask=jnp.ones((1, 8), bool), seed=5)
    timagen = it.Imagen(it.Unet(**WIDE, device=CPU), device=CPU, **kw)
    load_into(timagen.unets[0], params)
    return jimagen, timagen, params


def _trainer(timagen, momentum_dtype=torch.bfloat16):
    trainer = it.ImagenTrainer(timagen, use_ema=False, verbose=False, **OPT)
    trainer._ensure_state(0)
    trainer.optimizers[0].momentum_dtype = momentum_dtype
    return trainer


@pytest.mark.parametrize('momentum_dtype', ['float32', 'bfloat16'])
def test_adafactor_matches_optax_chain(tmp_path, monkeypatch, momentum_dtype):
    """Four updates, saved and loaded after the second. With the momentum in
    fp32 on both sides (optax's `dtype_momentum` monkeypatched in the JAX
    trainer's chain) every parameter agrees to 1e-6. With the trainers' bf16
    momentum the two packages' fp32 updates differ by their roundings, so
    now and then one rounds an element's momentum to the other bf16
    neighbour, and that element then moves by up to 2^-8 of its momentum
    differently: every element whose bf16 momentum ever differed between the
    packages is counted (under 1e-3 of them) and held to 1e-5, every other
    to 1e-6."""
    if momentum_dtype == 'float32':
        adafactor = optax.adafactor
        monkeypatch.setattr(optax, 'adafactor',
                            lambda **kw: adafactor(**{**kw, 'dtype_momentum': jnp.float32}))
    jimagen, timagen, params = _imagens()
    chain = JTrainer(imagen=jimagen, use_ema=False, verbose=False, **OPT)._optimizers[0]
    trainer = _trainer(timagen, getattr(torch, momentum_dtype))
    r = rng(6)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = chain.init(jp)
    update = jax.jit(chain.update)
    flipped = {}   # the elements whose momentum differed between the packages
    for step in range(UPDATES):
        if step == SAVED_AFTER:   # a fresh trainer carries on from the checkpoint
            trainer.save(tmp_path / 'adafactor.pt')
            fresh = it.Imagen(it.Unet(**WIDE, device=CPU), image_sizes=(16,),
                              text_embed_dim=128, timesteps=4, device=CPU)
            trainer = _trainer(fresh, getattr(torch, momentum_dtype))
            trainer.load(tmp_path / 'adafactor.pt')
        grads = jax.tree_util.tree_map(lambda a: randn(r, *a.shape), params)
        updates, state = update(jax.tree_util.tree_map(jnp.asarray, grads), state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)
        named = dict(trainer.unets[0].named_parameters())
        for k, g in state_dict_from_jax(grads).items():
            named[k].grad = g.clone()
        trainer._apply_update(0)
        ema = jax.tree_util.tree_map(lambda m: np.asarray(m.astype(jnp.float32)),
                                     _momentum_state(state))
        opt = trainer.optimizers[0]
        for k, m in state_dict_from_jax(ema).items():
            # fp32 momenta differ by roundings alone; bf16 ones are equal or a neighbour apart
            differs = (opt.state[named[k]]['momentum'].float() != m
                       if momentum_dtype == 'bfloat16' else torch.zeros(m.shape, dtype=bool))
            flipped[k] = flipped.get(k, torch.zeros_like(differs)) | differs

    ref, start = state_dict_from_jax(jp), state_dict_from_jax(params)
    named = dict(trainer.unets[0].named_parameters())
    n_flipped = sum(int(f.sum()) for f in flipped.values())
    n_total = sum(p.numel() for p in named.values())
    for k, p in named.items():
        err = (p.detach() - ref[k]).abs()
        assert _worst(err, ~flipped[k]) <= 1e-6, k
        assert _worst(err, flipped[k]) <= 1e-5, k
    assert n_flipped <= 1e-3 * n_total
    for k in ('text_to_cond.weight', 'attn_pool.pos_emb.weight', 'init_conv.convs.0.weight',
              'to_text_non_attn_cond.0.weight'):   # square, factored, unfactored and vector tensors moved
        assert max_abs(named[k], start[k]) > 1e-4, k
    assert trainer.num_steps_taken(1) == UPDATES

    # the state as the optax bundle holds it, the momentum in its dtype after the load
    opt = trainer.optimizers[0]
    kinds = set()
    for name, p in named.items():
        st = opt.state[p]
        assert st['step'] == UPDATES and st['momentum'].dtype == getattr(torch, momentum_dtype)
        assert bool(st['momentum'].any()), name
        dims = factored_dims(p.shape)
        if dims is None:
            assert 'v_row' not in st and st['v'].shape == p.shape
            kinds.add('vector' if p.ndim == 1 else 'full')
        else:
            d1, d0 = dims
            assert st['v_row'].shape == tuple(np.delete(p.shape, d0))
            assert st['v_col'].shape == tuple(np.delete(p.shape, d1))
            assert 'v' not in st
            kinds.add('square' if p.shape[0] == p.shape[1] else 'factored')
    assert kinds == {'vector', 'full', 'square', 'factored'}


def _worst(err, where):
    return float(err[where].max()) if bool(where.any()) else 0.


def _momentum_state(state):
    """The momentum tree of the JAX trainer's chain state (optax's `EmaState`)."""
    found = [s.ema for s in jax.tree_util.tree_leaves(
        state, is_leaf=lambda s: isinstance(s, optax.EmaState)) if isinstance(s, optax.EmaState)]
    assert len(found) == 1
    return found[0]


@pytest.mark.parametrize('shape', [(128, 128), (256, 128), (128, 3, 3, 160)])
def test_factored_update_is_symmetric_in_its_axes(shape):
    """The same gradients on a tensor and on its transpose (the two factored
    axes swapped) give transposed updates: the port's layout need not
    mirror the JAX one's axis order."""
    r = rng(7)
    w = t(randn(r, *shape, scale=0.1))
    perm = list(range(len(shape)))
    dims = factored_dims(shape)
    perm[dims[0]], perm[dims[1]] = perm[dims[1]], perm[dims[0]]
    a, b = torch.nn.Parameter(w.clone()), torch.nn.Parameter(w.permute(perm).contiguous())
    # an fp32 momentum: in bf16 the two runs' roundings may pick other neighbours
    opts = [Adafactor([p], lr=1e-2, decay_rate=0.99, momentum=0.9) for p in (a, b)]
    for opt in opts:
        opt.momentum_dtype = torch.float32
    for _ in range(3):
        g = t(randn(r, *shape))
        a.grad, b.grad = g.clone(), g.permute(perm).contiguous()
        for opt in opts:
            opt.step()
    assert max_abs(a.detach().permute(perm), b) <= 1e-7
    assert max_abs(a, w) > 1e-3


def test_adafactor_without_momentum_keeps_no_first_moment():
    p = torch.nn.Parameter(torch.ones(130, 129))
    opt = Adafactor([p], lr=0.1, momentum=None)
    p.grad = torch.full_like(p, 0.5)
    opt.step()
    assert set(opt.state[p]) == {'step', 'v_row', 'v_col'}
    # a constant gradient: every factor is 1/|g|, the update lr * 1 * rms(p) = 0.1
    assert max_abs(p, torch.full_like(p, 0.9)) <= 1e-6
