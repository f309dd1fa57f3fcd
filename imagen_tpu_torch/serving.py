"""Fixed-batch sampling server; counterpart of `imagen_tpu/serving.py`.

- warms up every cascade stage at startup for the serving batch at each
  cond_scale in `cond_scales` (the first call builds the CUDA kernels and
  lets cuDNN pick its algorithms, the second captures each U-Net's forward
  into a CUDA graph that later steps replay; serving requests must not pay
  that),
- pads incoming requests to the serving batch and text length, so every
  request runs the same shapes,
- serializes device access with a lock so several threads can call
  `generate`.

Single process, one request batch at a time: no queue, no batching across
callers. Raw `texts=` go through the cascade's T5 encoder
(`models/t5.py`) on its device. `from_checkpoint` builds the server from a
self-describing checkpoint (the port's or the JAX package's), EMA weights
preferred.
"""
from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from imagen_tpu_torch.utils.helpers import cast_tuple, default, exists
from imagen_tpu_torch.utils.profiling import span


class ImagenServer:
    """Fixed-shape sampling server around an `Imagen` whose unets hold their
    weights. `cond_scales` are the guidance scales warmed at startup
    (default `(cond_scale,)`); `lowres_sample_noise_level` goes to every
    sample (None: the cascade's own)."""

    def __init__(self, imagen, *, batch_size=4, text_len=256, cond_scale=3., cond_scales=None,
                 lowres_sample_noise_level=None, seed=0, video_frames=8, warmup=True):
        self.imagen = imagen
        self.batch_size = batch_size
        self.video_frames = video_frames  # frames per sample of a video cascade
        self.text_len = text_len
        self.cond_scale = cond_scale
        self.cond_scales = tuple(cast_tuple(default(cond_scales, cond_scale)))
        self.lowres_sample_noise_level = lowres_sample_noise_level
        self.device = imagen.device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._lock = threading.Lock()
        if warmup:
            self.warmup()

    @classmethod
    def from_checkpoint(cls, checkpoint_path, *, load_ema=True, device=None, **kwargs):
        """A server around the cascade that `checkpoint_path` describes, with its
        EMA weights where it has them (`load_ema`), on `device` (None: the card)."""
        from imagen_tpu_torch.utils.load import load_imagen_from_checkpoint
        imagen = load_imagen_from_checkpoint(checkpoint_path, load_ema_if_available=load_ema,
                                             device=device)
        return cls(imagen.eval(), **kwargs)

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def warmup(self):
        """Run every cascade stage at the serving shape, at each warmed cond_scale."""
        embeds = torch.zeros((self.batch_size, self.text_len, self.imagen.text_embed_dim),
                             device=self.device)
        masks = torch.ones((self.batch_size, self.text_len), dtype=torch.bool,
                           device=self.device)
        with self._lock:
            for scale in self.cond_scales:
                self._sample(embeds, masks, torch.Generator(device=self.device).manual_seed(0),
                             scale)
            self._sync()
        return self

    def _sample(self, text_embeds, text_masks, generator, cond_scale):
        kwargs = dict(video_frames=self.video_frames) if self.imagen.is_video else {}
        return self.imagen.sample(text_embeds=text_embeds, text_masks=text_masks,
                                  cond_scale=cond_scale,
                                  lowres_sample_noise_level=self.lowres_sample_noise_level,
                                  use_tqdm=False, generator=generator, **kwargs)

    def _pad_request(self, text_embeds, text_masks):
        """Pad or cut a request to (batch_size, text_len)."""
        n, t = text_embeds.shape[:2]
        if n > self.batch_size:
            raise ValueError(f'request batch {n} exceeds serving batch {self.batch_size}; '
                             'chunk it')
        if t < self.text_len:
            text_embeds = F.pad(text_embeds, (0, 0, 0, self.text_len - t))
            text_masks = F.pad(text_masks, (0, self.text_len - t), value=False)
        elif t > self.text_len:
            text_embeds = text_embeds[:, :self.text_len]
            text_masks = text_masks[:, :self.text_len]

        if n < self.batch_size:
            pad_n = self.batch_size - n
            text_embeds = torch.cat((text_embeds, text_embeds.new_zeros(
                (pad_n, *text_embeds.shape[1:]))))
            # padding rows attend nothing real; keep one True to avoid all-masked rows
            pad_mask = text_masks.new_zeros((pad_n, self.text_len))
            pad_mask[:, 0] = True
            text_masks = torch.cat((text_masks, pad_mask))
        return text_embeds, text_masks, n

    def generate(self, *, texts=None, text_embeds=None, text_masks=None, generator=None,
                 cond_scale=None):
        """Sample images for up to `batch_size` prompts; returns (n, H, W, C)
        in [0, 1], or (n, video_frames, H, W, C) from a video cascade.
        `cond_scale` defaults to the server's; one outside the warmed
        `cond_scales` runs all the same."""
        with span('serve.generate'):
            if exists(texts):
                if exists(text_embeds):
                    raise ValueError('pass texts or text_embeds, not both')
                text_embeds, text_masks = self.imagen.encode_text(texts, return_attn_mask=True)
            if not exists(text_embeds):
                raise ValueError('texts or text_embeds required')
            text_embeds = torch.as_tensor(text_embeds, device=self.device).float()
            text_masks = (text_embeds != 0.).any(dim=-1) if text_masks is None \
                else torch.as_tensor(text_masks, device=self.device).bool()

            text_embeds, text_masks, n = self._pad_request(text_embeds, text_masks)

            with self._lock:
                out = self._sample(text_embeds, text_masks, default(generator, self.generator),
                                   default(cond_scale, self.cond_scale))
                images = out[:n].float().cpu().numpy()
            return images
