"""The port's optimiser, EMA and trainer, on the CPU.

Against the JAX package, with the same seeded numpy gradients and weights
(bridged by `state_dict_from_jax`):
- three optimiser updates (clipping, masked weight decay, warmup and cosine)
  against the optax chain of the JAX trainer, 1e-6;
- the EMA against `imagen_tpu.ema` over 12 steps, decays equal to fp32.
Then the trainer itself: the loss falls, ragged accumulation, checkpoints,
strict keyword arguments, and the generators and device defaults.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_bridge import load_into, max_abs, randn, random_params, rng, t

from imagen_tpu import ema as jema
from imagen_tpu.diffusion.imagen import Imagen as JImagen
from imagen_tpu.models.unet2d import Unet as JUnet
from imagen_tpu.trainer import ImagenTrainer as JTrainer

import imagen_tpu_torch as it
from imagen_tpu_torch import ema
from imagen_tpu_torch.optim import Adafactor
from imagen_tpu_torch.ops.tensor_utils import prob_mask_like
from imagen_tpu_torch.trainer import split_batch_ragged
from imagen_tpu_torch.utils.port_weights import state_dict_from_jax

CPU = 'cpu'


# --- optimiser and EMA ----------------------------------------------------------------------

TINY = dict(dim=8, dim_mults=(1, 2), text_embed_dim=16, cond_dim=8, attn_dim_head=4,
            attn_heads=2, attn_pool_num_latents=2, max_text_len=8, layer_attns=False,
            layer_cross_attns=(False, True))
OPT = dict(lr=3e-3, max_grad_norm=0.5, weight_decay=0.1, warmup_steps=2,
           cosine_decay_max_steps=5)


def test_optimiser_matches_optax_chain():
    jimagen = JImagen(unets=(JUnet(**TINY),), image_sizes=(16,), text_embed_dim=16,
                      timesteps=4)
    chain = JTrainer(imagen=jimagen, use_ema=False, verbose=False, **OPT)._optimizers[0]
    params = random_params(jimagen.unets[0], jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,)),
                           text_embeds=jnp.zeros((1, 8, 16)),
                           text_mask=jnp.ones((1, 8), bool), seed=3)
    timagen = it.Imagen(it.Unet(**TINY, device=CPU), image_sizes=(16,), text_embed_dim=16,
                        timesteps=4, device=CPU)
    load_into(timagen.unets[0], params)
    trainer = it.ImagenTrainer(timagen, use_ema=False, verbose=False, **OPT)
    trainer._ensure_state(0)

    r = rng(4)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = chain.init(jp)
    update = jax.jit(chain.update)  # one compile, not one per leaf and op
    named = dict(timagen.unets[0].named_parameters())
    for _ in range(3):
        grads = jax.tree_util.tree_map(lambda a: randn(r, *a.shape), params)
        updates, state = update(jax.tree_util.tree_map(jnp.asarray, grads), state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)
        for k, g in state_dict_from_jax(grads).items():
            named[k].grad = g.clone()
        trainer._apply_update(0)
    ref = state_dict_from_jax(jp)
    moved = 0.
    for k, p in named.items():
        assert max_abs(p, ref[k]) <= 1e-6, k
        moved = max(moved, max_abs(p, state_dict_from_jax(params)[k]))
    assert moved > 1e-3
    assert trainer.num_steps_taken(1) == 3


def test_ema_matches_jax():
    cfg = dict(update_after_step=2, update_every=3, beta=0.99, power=0.75)
    r = rng(7)
    e, p = randn(r, 5, 4), randn(r, 5, 4)
    je, te = jnp.asarray(e), t(e)
    jcfg, tcfg = jema.EMAConfig(**cfg), ema.EMAConfig(**cfg)
    for step in range(1, 13):
        p = p + randn(r, 5, 4, scale=0.1)
        assert ema.ema_decay(tcfg, step) == float(jema.ema_decay(jcfg, jnp.asarray(step)))
        je = jema.ema_update(jcfg, je, jnp.asarray(p), jnp.asarray(step))
        ema.ema_update(tcfg, [te], [t(p)], step)
        assert max_abs(te, je) <= 1e-6, step
    assert max_abs(te, e) > 0.1


# --- the trainer ----------------------------------------------------------------------------

def _tiny_trainer(**kwargs):
    torch.manual_seed(0)
    imagen = it.Imagen(it.Unet(**TINY, device=CPU), image_sizes=(16,), text_embed_dim=16,
                       timesteps=4, cond_drop_prob=0.1, device=CPU)
    return it.ImagenTrainer(imagen, verbose=False, **kwargs)


def _batch(b, seed=0):
    r = rng(seed)
    return dict(images=t(r.rand(b, 16, 16, 3).astype(np.float32)),
                text_embeds=t(randn(r, b, 6, 16)))


def _fixed_loss(trainer, batch):
    with torch.no_grad():
        return float(trainer.imagen(batch['images'], text_embeds=batch['text_embeds'],
                                    generator=torch.Generator().manual_seed(99)))


def test_trainer_loss_decreases_and_ema_moves():
    trainer = _tiny_trainer(lr=1e-3, max_grad_norm=1.0, ema_update_after_step=0,
                            ema_update_every=1)
    batch = _batch(8)
    before = _fixed_loss(trainer, batch)
    losses = [trainer.step_with_batch(batch) for _ in range(6)]
    assert all(np.isfinite(losses))
    assert _fixed_loss(trainer, batch) < before
    assert trainer.num_steps_taken(1) == 6
    assert trainer.timings()['n'] == 6
    online, ema_unet = trainer.unets[0], trainer.ema_unets[0]
    assert any(not torch.equal(a, b) for a, b in zip(online.parameters(),
                                                      ema_unet.parameters()))
    with trainer.use_ema_unets():
        assert trainer.unets[0] is ema_unet
        with pytest.raises(RuntimeError):
            trainer.step_with_batch(batch)
    assert trainer.unets[0] is online
    images = trainer.sample(text_embeds=batch['text_embeds'][:2])
    assert images.shape == (2, 16, 16, 3) and bool(torch.isfinite(images).all())


def test_ragged_accumulation_weights_chunks_like_the_full_batch():
    """b = 7 at max_batch_size 3 runs chunks of 3, 3, 1 weighted 3:3:1: the
    loss and gradient equal the weighted sum of the chunks taken alone with
    the same generator draws, which is the full batch's mean."""
    batch = _batch(7, seed=1)
    chunks, sizes = split_batch_ragged(batch, 3)
    assert sizes == [3, 3, 1] and [c['images'].shape[0] for c in chunks] == sizes

    trainer = _tiny_trainer(use_ema=False)
    unet = trainer.unets[0]
    trainer.generator.manual_seed(5)
    expected_loss, expected = 0., None
    for chunk, n in zip(chunks, sizes):
        unet.zero_grad()
        loss = trainer.imagen(chunk['images'], text_embeds=chunk['text_embeds'],
                              generator=trainer.generator)
        loss.backward()
        expected_loss += float(loss.detach()) * n / 7
        g = [p.grad.clone() * (n / 7) for p in unet.parameters()]
        expected = g if expected is None else [a + b for a, b in zip(expected, g)]
    unet.zero_grad(set_to_none=True)

    trainer.generator.manual_seed(5)
    loss = trainer._backward(0, batch, max_batch_size=3)
    assert abs(float(loss) - expected_loss) <= 1e-6
    for p, g in zip(unet.parameters(), expected):
        assert max_abs(p.grad, g) <= 1e-6

    # the two-phase API accumulates the same way over separate calls
    trainer = _tiny_trainer(use_ema=False)
    trainer.forward(**_batch(4, seed=2))
    trainer.forward(**_batch(3, seed=3), max_batch_size=2)
    trainer.update()
    assert trainer.num_steps_taken(1) == 1
    with pytest.raises(RuntimeError):
        trainer.update()


def test_checkpoint_round_trip(tmp_path):
    trainer = _tiny_trainer(ema_update_after_step=0, ema_update_every=1)
    batch = _batch(4)
    for _ in range(2):
        trainer.step_with_batch(batch)
    path = tmp_path / 'ckpt.pt'
    trainer.save(path)
    with pytest.raises(FileExistsError):
        trainer.save(path, overwrite=False)

    other = _tiny_trainer(ema_update_after_step=0, ema_update_every=1, seed=1)
    other.step_with_batch(_batch(4, seed=9))
    other.load(path)
    assert other.num_steps_taken(1) == 2
    for a, b in zip(trainer.unets[0].state_dict().values(),
                    other.unets[0].state_dict().values()):
        assert torch.equal(a, b)
    for a, b in zip(trainer.ema_unets[0].state_dict().values(),
                    other.ema_unets[0].state_dict().values()):
        assert torch.equal(a, b)
    sa, sb = trainer.optimizers[0].state_dict(), other.optimizers[0].state_dict()
    for k, st in sa['state'].items():
        for name, v in st.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(sb['state'][k][name]))
    assert other.get_lr(1) == trainer.get_lr(1)
    # the next step is the same step on both
    trainer.generator.manual_seed(3)
    other.generator.manual_seed(3)
    assert trainer.step_with_batch(batch) == other.step_with_batch(batch)
    assert other.load(tmp_path / 'missing.pt', noop_if_not_exist=True) is None


def test_trainer_rejects_unknown_options():
    with pytest.raises(TypeError):
        _tiny_trainer(weight_decays=0.1)
    with pytest.raises(TypeError):
        _tiny_trainer(ema_bogus=1)
    with pytest.raises(ValueError, match='unknown optimizer'):
        _tiny_trainer(optimizer='lion')
    assert isinstance(_tiny_trainer(optimizer='adafactor')._make_optimizer(0), Adafactor)
    # split_batches: taken and read nowhere, as the JAX trainer takes it
    assert np.isfinite(_tiny_trainer(split_batches=True).step_with_batch(_batch(2)))
    trainer = _tiny_trainer(only_train_unet_number=1)
    with pytest.raises(ValueError):
        trainer.step_with_batch(_batch(2), unet_number=2)


def test_precision_bf16_computes_in_bf16_over_fp32_parameters():
    """`precision='bf16'` (or `fp16=True`) is the JAX trainer's
    `unet.clone(dtype=bfloat16)`: bf16 activations, fp32 parameters."""
    trainer = _tiny_trainer(precision='bf16')
    unet = trainer.unets[0]
    assert unet.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in unet.parameters())
    assert np.isfinite(trainer.step_with_batch(_batch(2)))
    assert all(p.dtype == torch.float32 for p in unet.parameters())
    with pytest.raises(ValueError):
        _tiny_trainer(fp16=True, precision='bf16')


def test_weight_decay_mask_follows_jax_layout():
    """group_wd_params decays exactly the tensors the JAX trainer's mask
    (ndim >= 2 in the flax layout) decays."""
    params = random_params(JUnet(**TINY), jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,)),
                           text_embeds=jnp.zeros((1, 8, 16)),
                           text_mask=jnp.ones((1, 8), bool))
    flags = state_dict_from_jax(jax.tree_util.tree_map(
        lambda a: np.full(a.shape, float(a.ndim >= 2), np.float32), params))
    expected = {k for k, v in flags.items() if bool(v.flatten()[0])}
    trainer = _tiny_trainer(weight_decay=0.1)
    trainer._ensure_state(0)
    decayed = {id(p) for g in trainer.optimizers[0].param_groups if g['weight_decay'] > 0
               for p in g['params']}
    names = {k for k, p in trainer.unets[0].named_parameters() if id(p) in decayed}
    assert names == expected
    assert 'downs.0.1.block1.norm.gamma' not in names


def test_prob_mask_like_draws_from_the_generator():
    a = prob_mask_like((64,), 0.5, CPU, generator=torch.Generator().manual_seed(1))
    b = prob_mask_like((64,), 0.5, CPU, generator=torch.Generator().manual_seed(1))
    c = prob_mask_like((64,), 0.5, CPU, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    torch.manual_seed(0)
    d = prob_mask_like((64,), 0.5, CPU, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, d)  # the global generator plays no part


def test_unet_without_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip('a GPU is present: the default device builds')
    with pytest.raises(RuntimeError, match='device="cpu"'):
        it.Unet(**TINY)
    with pytest.raises(RuntimeError):
        it.NullUnet()
    with pytest.raises(RuntimeError):
        it.Imagen(it.Unet(**TINY, device=CPU), image_sizes=(16,), text_embed_dim=16)
