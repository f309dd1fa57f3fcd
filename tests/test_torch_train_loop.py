"""The port's training loop against the JAX trainer, fp32 on the CPU.

Both trainers start from the same seeded weights (bridged by
`state_dict_from_jax`), read the same dataset through `add_train_dataset`
with `split_valid_from_train` (the same rows split off, the same shuffled
batches, the 3-row validation split batched whole under `drop_last`) and
take the same steps: `train_step` with gradient accumulation, `valid_step`
on the online and the EMA unet with ragged chunks weighted by size, and
`step_with_dl_iter` on a tuple batch. The two trainers draw their
randomness from different generators, so both packages' `p_losses` are
wrapped to take times and noise made from the images alone (as
`test_torch_video_training.py` stubs them); the loss is then a function of
the weights and the batch, and every loss agrees to 1e-4.

Then `sample(max_batch_size=)` chunking (tensors, PIL images, every
stage's output), and the T5 path: the same tiny random T5 injected into
both packages' `T5_CONFIGS` gives the same embeddings (1e-5), and `texts=`
trains and samples as those embeddings do.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_bridge import TINY_T5, inject_t5, jparams, load_into, max_abs, randn, \
    random_params, rng, t, tiny_t5

from imagen_tpu.diffusion.imagen import Imagen as JImagen
from imagen_tpu.models import t5 as jt5
from imagen_tpu.models.unet2d import Unet as JUnet
from imagen_tpu.trainer import ImagenTrainer as JTrainer

import imagen_tpu_torch as it
from imagen_tpu_torch.models import t5

CPU = 'cpu'
TINY = dict(dim=8, dim_mults=(1, 2), text_embed_dim=16, cond_dim=8, attn_dim_head=4,
            attn_heads=2, attn_pool_num_latents=2, max_text_len=8, layer_attns=False,
            layer_cross_attns=(False, True))
IMAGEN = dict(image_sizes=(16,), text_embed_dim=16, timesteps=4, cond_drop_prob=0.)
# Adam moves a weight by about lr whatever the size of its gradient, so where a
# gradient is near 0 the two packages' fp32 rounding (gradients agree to ~5e-4
# of the largest, as in test_torch_gradients.py) can send it either way: lr
# bounds how far the weights, and so the later losses, drift apart
TRAINER = dict(lr=1e-5, max_grad_norm=1.0, ema_update_after_step=0, ema_update_every=1,
               split_valid_from_train=True, split_valid_fraction=0.25, verbose=False)


def _times_and_noise(x, lib):
    """Times in (0.05, 0.95) and unit-scale noise, from the images alone
    (`lib` is jnp or torch)."""
    mean = x.mean((1, 2, 3)) * 13.7
    return 0.05 + 0.9 * (mean - lib.floor(mean)), lib.sin(x * 12.9898 + 78.233) * 1.7


def _pin_draws(monkeypatch):
    jp_losses, tp_losses = JImagen.p_losses, it.Imagen.p_losses

    def jax_p_losses(self, unet, variables, x_start, times, key, **kw):
        times, noise = _times_and_noise(x_start, jnp)
        return jp_losses(self, unet, variables, x_start, times, key, **{**kw, 'noise': noise})

    def torch_p_losses(self, unet, x_start, times, **kw):
        times, noise = _times_and_noise(x_start, torch)
        return tp_losses(self, unet, x_start, times, **{**kw, 'noise': noise})

    monkeypatch.setattr(JImagen, 'p_losses', jax_p_losses)
    monkeypatch.setattr(it.Imagen, 'p_losses', torch_p_losses)


def _dataset(n=12, seed=3):
    r = rng(seed)
    items = []
    for _ in range(n):
        mask = np.arange(8) < r.randint(3, 9)
        items.append((r.rand(16, 16, 3).astype(np.float32),
                      randn(r, 8, 16) * mask[:, None], mask))
    return items


@pytest.fixture
def trainers(monkeypatch):
    _pin_draws(monkeypatch)
    jimagen = JImagen(unets=(JUnet(**TINY),), **IMAGEN)
    params = random_params(jimagen.unets[0], jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,)),
                           text_embeds=jnp.zeros((1, 8, 16)),
                           text_mask=jnp.ones((1, 8), bool), seed=11)
    jtrainer = JTrainer(imagen=jimagen, **TRAINER)
    jtrainer.params[0] = jparams(params)
    jtrainer.ema_params[0] = jparams(params)
    jtrainer.opt_states[0] = jtrainer._optimizers[0].init(jtrainer.params[0])

    timagen = it.Imagen((load_into(it.Unet(**TINY, device=CPU), params),), **IMAGEN,
                        device=CPU)
    ttrainer = it.ImagenTrainer(timagen, **TRAINER)
    ds = _dataset()
    for trainer in (jtrainer, ttrainer):
        trainer.add_train_dataset(ds, batch_size=4, seed=7)
    start = {k: v.clone() for k, v in ttrainer.unets[0].state_dict().items()}
    return jtrainer, ttrainer, ds, start


def _close(mine, ref):
    assert np.isfinite(ref) and abs(mine - ref) <= 1e-4, (mine, ref)


def test_train_valid_and_dl_iter_steps_match_jax(trainers):
    jtrainer, ttrainer, ds, start = trainers
    assert len(ttrainer.train_dl) == len(jtrainer.train_dl) == 2
    assert list(ttrainer.valid_dl.dataset.indices) == jtrainer.valid_dl.dataset.indices

    for _ in range(2):
        _close(ttrainer.train_step(unet_number=1, max_batch_size=2),
               jtrainer.train_step(unet_number=1, max_batch_size=2))
    assert ttrainer.num_steps_taken(1) == jtrainer.num_steps_taken(1) == 2

    for use_ema in (False, True):
        _close(ttrainer.valid_step(unet_number=1, max_batch_size=2, use_ema_unets=use_ema),
               jtrainer.valid_step(unet_number=1, max_batch_size=2, use_ema_unets=use_ema))
    assert ttrainer.unets[0].training   # the trainer leaves its unets in train mode

    batch = tuple(np.stack(col) for col in zip(*ds[:4]))
    _close(ttrainer.step_with_dl_iter(iter([batch]), unet_number=1, max_batch_size=2),
           jtrainer.step_with_dl_iter(iter([batch]), unet_number=1, max_batch_size=2))
    assert ttrainer.num_steps_taken(1) == 3

    from imagen_tpu_torch.utils.port_weights import state_dict_from_jax
    for name, params in (('online', jtrainer.params[0]), ('ema', jtrainer.ema_params[0])):
        expected = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
        module = ttrainer.unets[0] if name == 'online' else ttrainer.ema_unets[0]
        for k, v in module.state_dict().items():
            assert max_abs(v, expected[k]) <= 1e-4, (name, k)
        mine = torch.cat([(v - start[k]).flatten() for k, v in module.state_dict().items()])
        ref = torch.cat([(expected[k] - start[k]).flatten() for k in module.state_dict()])
        # the steps moved the weights: a no-op, or an accumulation that drops a
        # chunk, moves them elsewhere. Where a gradient is near 0 its sign, and
        # so Adam's lr-sized step, can differ (see TRAINER), so a few weights
        # differ by up to 2 lr per step and the rest agree closely
        assert float(ref.abs().max()) >= 2 * TRAINER['lr'], name
        off = (mine - ref).abs() > 1e-2 * ref.abs().max()
        assert float((mine - ref).norm() / ref.norm()) <= 2e-2, name
        assert float(off.float().mean()) <= 1e-3, name


def test_loss_without_host_sync_and_loader_errors():
    timagen = it.Imagen((it.Unet(**TINY, device=CPU),), **IMAGEN, device=CPU)
    trainer = it.ImagenTrainer(timagen, sync_loss=False, verbose=False)
    with pytest.raises(RuntimeError, match='not registered'):
        trainer.train_step()
    trainer.add_train_dataset(_dataset(5), batch_size=2)
    loss = trainer.train_step()
    assert isinstance(loss, torch.Tensor) and loss.ndim == 0 and bool(torch.isfinite(loss))
    with pytest.raises(RuntimeError, match='already added'):
        trainer.add_train_dataset(_dataset(5), batch_size=2)
    assert trainer.is_main and not trainer.is_distributed
    assert trainer.get_ema_unet(1) is trainer.ema_unets[0]


def test_sample_in_chunks():
    torch.manual_seed(0)
    timagen = it.Imagen((it.Unet(**TINY, device=CPU),), **{**IMAGEN, 'cond_drop_prob': 0.1},
                        device=CPU)
    trainer = it.ImagenTrainer(timagen, use_ema=False, verbose=False)
    emb = t(randn(rng(5), 5, 8, 16))
    out = trainer.sample(text_embeds=emb, max_batch_size=2, cond_scale=2.,
                         generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(1)
    ref = torch.cat([timagen.sample(text_embeds=emb[i:i + 2], cond_scale=2., generator=g)
                     for i in (0, 2, 4)])
    assert out.shape == (5, 16, 16, 3) and torch.equal(out, ref)
    pil = trainer.sample(text_embeds=emb, max_batch_size=2, return_pil_images=True)
    assert len(pil) == 5 and pil[0].size == (16, 16)
    stages = trainer.sample(text_embeds=emb, max_batch_size=3, return_all_unet_outputs=True)
    assert len(stages) == 1 and stages[0].shape == (5, 16, 16, 3)
    assert trainer.sample(text_embeds=emb[:2], max_batch_size=2).shape == (2, 16, 16, 3)


def test_t5_path_matches_jax(monkeypatch):
    inject_t5(monkeypatch, tiny_t5(16), jax_side=True)
    texts = ['a red fox in the snow', 'sky', 'two birds on a long wire at dusk']
    emb, mask = t5.t5_encode_text(texts, name=TINY_T5, return_attn_mask=True, device=CPU)
    jemb, jmask = jt5.t5_encode_text(texts, name=TINY_T5, return_attn_mask=True)
    assert emb.shape == jemb.shape == (3, 9, 16) and emb.dtype == torch.float32
    assert np.array_equal(mask.numpy(), np.asarray(jmask))
    assert max_abs(emb, jemb) <= 1e-5 and float(emb.abs().max()) > 0.1
    assert float(emb[~mask].abs().max()) == 0.   # padding positions zeroed
    assert t5.get_encoded_dim(TINY_T5) == jt5.get_encoded_dim(TINY_T5) == 16

    # texts= train and sample as their embeddings do
    torch.manual_seed(0)
    timagen = it.Imagen((it.Unet(**TINY, device=CPU),),
                        **{**IMAGEN, 'text_embed_dim': None, 'cond_drop_prob': 0.1},
                        text_encoder_name=TINY_T5, device=CPU)
    assert timagen.text_embed_dim == 16
    trainer = it.ImagenTrainer(timagen, use_ema=False, verbose=False)
    assert torch.equal(trainer.encode_text(texts), emb)
    images = t(rng(6).rand(3, 16, 16, 3).astype(np.float32))
    losses = []
    for batch in (dict(images=images, texts=texts),
                  dict(images=images, text_embeds=emb, text_masks=mask)):
        with torch.no_grad():
            losses.append(float(timagen(batch['images'], generator=torch.Generator().manual_seed(4),
                                        **{k: v for k, v in batch.items() if k != 'images'})))
    assert losses[0] == losses[1]
    assert np.isfinite(trainer.step_with_batch(dict(images=images, texts=texts)))
    g = lambda: torch.Generator().manual_seed(8)   # noqa: E731
    assert torch.equal(timagen.sample(texts=texts, generator=g()),
                       timagen.sample(text_embeds=emb, text_masks=mask, generator=g()))
