"""The port's EDM sampler against the JAX package's with inpainting,
RePaint, `init_images` and `skip_steps`.

The tiny 16 -> 32 cascade (dim-8 base and SR unets, 3 + 3 churn + Heun
steps, S_churn 80, classifier-free guidance at cond_scale 3) inpaints a 32
px image with a half-image mask and 2 RePaint resamples a step, starts each
stage from `init_images` and skips stage 2's first step, every draw fed
through `noise_override` ('init', 'eps' and 'repaint' per (step, r); the
low-res augmentation draw recomputed as JAX makes it). In fp32 the two
packages' roundings, renoised by RePaint from sigma_max, leave stage 1
about 0.3 apart, so the cascade runs in float64 on both sides, as
`test_torch_elucidated.py::test_cascade_end_to_end_in_float64_matches_jax`
runs it: the samples agree to 1e-6 and the known pixels equal the input
after `unnormalize(normalize(.))`. The first step of stage 1 runs at
sigma_max, out of the churn's range: its paste takes the known pixels with
no churn noise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_port_bridge import BASE_CFG, SR_CFG, load_into, max_abs, randn, random_params, \
    rng, softmax_in_input_dtype, t

from imagen_tpu.diffusion.elucidated import ElucidatedImagen as JElucidated
from imagen_tpu.models.unet2d import Unet as JUnet
from imagen_tpu.ops.tensor_utils import resize_image_to as jresize

import imagen_tpu_torch as it
from imagen_tpu_torch.ops import edm_math as em

SIZES, STEPS, SKIP, R, B = (16, 32), (3, 3), (0, 1), 2, 2


def test_edm_inpainting_repaint_init_images_and_skip_steps_match_jax(monkeypatch):
    softmax_in_input_dtype(monkeypatch)
    schedule = em.sample_schedule
    monkeypatch.setattr(em, 'sample_schedule', lambda *a: schedule(*a).astype(np.float64))
    kw = dict(image_sizes=SIZES, text_embed_dim=16, num_sample_steps=STEPS, cond_drop_prob=0.1)
    params = []
    for i, (unet, size) in enumerate(zip(JElucidated(unets=(JUnet(**BASE_CFG),
                                                            JUnet(**SR_CFG)), **kw).unets, SIZES)):
        x, time = jnp.zeros((1, size, size, 3)), jnp.zeros((1,))
        ukw = dict(text_embeds=jnp.zeros((1, 8, 16)), text_mask=jnp.ones((1, 8), bool))
        if unet.lowres_cond:
            ukw.update(lowres_cond_img=x, lowres_noise_times=time)
        params.append(random_params(unet, x, time, **ukw, seed=80 + i))

    r = rng(81)
    mask = np.ones((B, 8), bool)
    mask[0, 6:] = False
    emb = randn(r, B, 8, 16) * mask[..., None]
    images = r.rand(B, SIZES[1], SIZES[1], 3).astype(np.float32)
    masks = r.rand(B, SIZES[1], SIZES[1]) < 0.2
    masks[:, :, :SIZES[1] // 2] = True
    init = r.rand(B, SIZES[1], SIZES[1], 3).astype(np.float32)
    noise = [{'init': randn(r, B, s, s, 3), 'eps': randn(r, n - k, R, B, s, s, 3),
              'repaint': randn(r, n - k, R, B, s, s, 3)} for s, n, k in zip(SIZES, STEPS, SKIP)]
    call = dict(cond_scale=3., inpaint_resample_times=R, skip_steps=SKIP,
                return_all_unet_outputs=True)
    key = jax.random.PRNGKey(0)
    with jax.enable_x64(True):
        f64 = lambda a: jnp.asarray(np.asarray(a, np.float64))  # noqa: E731
        jimagen = JElucidated(unets=(JUnet(**BASE_CFG, dtype=jnp.float64),
                                     JUnet(**SR_CFG, dtype=jnp.float64)), **kw)
        jimagen.sample_schedule = lambda *a: jnp.asarray(em.sample_schedule(*a))
        ref = jimagen.sample(
            tuple({'params': jax.tree_util.tree_map(f64, p)} for p in params), key,
            text_embeds=f64(emb), text_masks=jnp.asarray(mask), inpaint_images=f64(images),
            inpaint_masks=jnp.asarray(masks), init_images=f64(init),
            noise_override=[{k: f64(v) for k, v in n.items()} for n in noise], use_tqdm=False,
            **call)
        lowres = np.asarray(jax.random.normal(jax.random.fold_in(key, 1000 + 1),
                                              (B, SIZES[1], SIZES[1], 3)))
    assert lowres.dtype == np.float64

    d64 = lambda a: torch.from_numpy(np.array(a, np.float64))  # noqa: E731
    tunets = [load_into(it.Unet(**cfg, dtype=torch.float64, device='cpu'), p).double()
              for cfg, p in zip((BASE_CFG, SR_CFG), params)]
    timagen = it.ElucidatedImagen(tunets, device='cpu', **kw)
    override = [{k: d64(v) for k, v in n.items()} for n in noise]
    override[1]['lowres'] = d64(lowres)
    outs = timagen.sample(text_embeds=d64(emb), text_masks=t(mask), inpaint_images=d64(images),
                          inpaint_masks=t(masks), init_images=d64(init), noise_override=override,
                          **call)
    for out, expected, size in zip(outs, ref, SIZES):
        assert out.dtype == torch.float64 and out.shape == (B, size, size, 3)
        assert max_abs(out, expected) <= 1e-6
        known = np.asarray(jresize(jnp.asarray(masks[..., None].astype(np.float32)),
                                   size)).astype(bool)[..., 0]
        # a nearest resize only picks pixels: the float32 result is the input's, exactly
        x = np.asarray(jresize(jnp.asarray(images), size)).astype(np.float64)
        assert known.any() and (~known).any()
        assert max_abs(out.numpy()[known], ((x * 2. - 1. + 1.) * 0.5)[known]) <= 1e-12
