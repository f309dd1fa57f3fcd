"""Cascading continuous-time DDPM (the `Imagen` class): sampling and the
training loss.

Counterpart of `imagen_tpu/diffusion/imagen.py`. Sampling: classifier-free
guidance as one doubled-batch forward, dynamic thresholding, low-res
noise-aug conditioning, and the stage loop as a plain Python loop over steps;
for a cascade of video unets (`Unet3D`) every stage samples NFHWC video of
`video_frames` frames (fewer where `temporal_downsample_factor` says so).
Prompt frames (`cond_video_frames`, `post_cond_video_frames`) are scaled in
time by each stage's `temporal_downsample_factor` (unless
`resize_cond_video_frames=False`). Every resize of images, video and masks
takes the cascade's `resize_mode`, a `jax.image.resize` method. The sampler
also takes inpainting with RePaint resampling, `init_images` with
`skip_steps`, `cond_images`, self-conditioned unets and a per-call low-res
noise level, and shows a per-stage progress bar with `use_tqdm`. The loss
runs the unet in train mode (its dropout on), sampling in eval mode.
Training (`forward` -> `p_losses`): random times, the degraded low-res
condition with its noise augmentation (resized in space and, for video, in
time), the paired random crop (per frame for video), `cond_images`, the
self-conditioning pass half of the time, the three objectives and min-SNR
weighting; still images train a video cascade as one-frame clips with
`ignore_time`. Every draw comes from a `torch.Generator` (or is passed in:
`noise_override` when sampling, `noise`, `lowres_aug_noise` and
`self_cond_flip` in `p_losses`).
"""
from __future__ import annotations

from contextlib import contextmanager, nullcontext
from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn

from imagen_tpu_torch.models.t5 import get_encoded_dim, t5_encode_text
from imagen_tpu_torch.models.unet2d import NullUnet
from imagen_tpu_torch.models.video_blocks import resize_video_to, scale_video_time
from imagen_tpu_torch.ops.diffusion_math import GaussianDiffusionContinuousTimes
from imagen_tpu_torch.parallel.rows import rows_of
from imagen_tpu_torch.ops.tensor_utils import (
    cast_uint8_images_to_float,
    normalize_neg_one_to_one,
    quantile_rows,
    resize_image_to,
    resize_kernel,
    right_pad_dims_to,
    unnormalize_zero_to_one,
)
from imagen_tpu_torch.utils.helpers import (
    cast_tuple,
    default,
    exists,
    pad_tuple_to_length,
    resolve_device,
    stage_progress,
)
from imagen_tpu_torch.utils.profiling import span

@contextmanager
def on_device(module, device):
    """`module` on `device` inside the block. A module parked elsewhere (say
    on the host) is copied to `device` for the block; after it, the module
    holds its parked tensors again, so the device copy is dropped. A module
    already on `device` is used as it is."""
    if next(module.parameters()).device == device:
        yield module
        return
    parked = [(m, kind, name, t, t.data) for m in module.modules()
              for kind in ('_parameters', '_buffers')
              for name, t in getattr(m, kind).items() if t is not None]
    module.to(device)
    try:
        yield module
    finally:
        for m, kind, name, t, data in parked:
            t.data = data
            getattr(m, kind)[name] = t


@contextmanager
def unet_mode(unet, training):
    """`unet` in train mode (dropout on) or eval mode inside the block, in
    its own mode again after it."""
    was_training = unet.training
    unet.train(training)
    try:
        yield unet
    finally:
        unet.train(was_training)


def _l1_loss(pred, target):
    return (pred - target).abs()


def _l2_loss(pred, target):
    return (pred - target) ** 2


def _huber_loss(pred, target, beta: float = 1.0):
    """smooth_l1 with beta 1."""
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff ** 2 / beta, diff - 0.5 * beta)


LOSS_FNS = {'l1': _l1_loss, 'l2': _l2_loss, 'huber': _huber_loss}

_CFG_BATCHED_KWARGS = ('text_embeds', 'text_mask', 'cond_images', 'lowres_cond_img',
                       'lowres_noise_times', 'self_cond', 'cond_video_frames',
                       'post_cond_video_frames')

# a DDPM stage's noise_override draws (see `Imagen.sample`)
_OVERRIDE_KEYS = ('init', 'inpaint', 'steps', 'renoise', 'lowres')


def override_draws(entry, keys):
    """`entry` without its None values; raises on a key outside `keys`."""
    unknown = set(entry) - set(keys)
    if unknown:
        raise ValueError(f'unknown noise_override keys {sorted(unknown)}; expected {keys}')
    return {k: v for k, v in entry.items() if v is not None}


def check_draw_shapes(noise, index, **shapes):
    """Each draw in `noise` has the shape `shapes` names for it."""
    for name, shape in shapes.items():
        if name in noise and tuple(noise[name].shape) != tuple(shape):
            raise ValueError(f'{name!r} noise of stage {index + 1} is '
                             f'{tuple(noise[name].shape)}, expected {tuple(shape)}')


def to_pil_images(out, is_video):
    """A batch of samples in [0, 1] as PIL images, or per clip a list of
    per-frame PIL images; PIL is imported only when asked for."""
    from PIL import Image
    out = out.detach().float().cpu()
    if not is_video:
        return [Image.fromarray((im * 255).clamp(0, 255).to(torch.uint8).numpy()) for im in out]
    clips = (out.clamp(0., 1.) * 255).round().to(torch.uint8)
    if clips.shape[-1] == 1:
        clips = clips[..., 0]
    return [[Image.fromarray(frame.numpy()) for frame in clip] for clip in clips]


class TrainingBatch(NamedTuple):
    """A training batch made ready for one stage's loss (`Imagen._training_batch`)."""
    index: int                                # the stage's unet index
    images: torch.Tensor                      # at the stage's size and frames, input range
    lowres_cond_img: Optional[torch.Tensor]   # the degraded low-res condition, input range
    cond: dict                                # the unet's conditioning kwargs


def unet_forward_with_cond_scale(unet, x, time, *, cond_scale=1., **kwargs):
    """Classifier-free guidance: lerp from the null prediction. The conditional
    and null branches run as ONE doubled-batch forward."""
    if cond_scale == 1:
        return unet(x, time, **kwargs)

    b = x.shape[0]

    def double(t):
        return torch.cat((t, t), dim=0) if exists(t) else t

    kwargs2 = {k: (double(v) if k in _CFG_BATCHED_KWARGS else v) for k, v in kwargs.items()}
    drop_mask = torch.cat((torch.zeros(b, dtype=torch.bool, device=x.device),
                           torch.ones(b, dtype=torch.bool, device=x.device)))
    both = unet(double(x), double(time), force_text_drop_mask=drop_mask, **kwargs2)
    logits, null_logits = both[:b], both[b:]
    return null_logits + (logits - null_logits) * cond_scale


def _per_sample_random_crop(tensors, crop_size, generator=None):
    """Paired per-sample random crop of NHWC tensors: the same offsets across
    the tensors, drawn per sample from `generator`. NFHWC video folds its
    frames into the batch, so each frame of each clip has its own offsets
    (the JAX package's fold, after lucidrains' crop of rearranged frames)."""
    if tensors[0].ndim == 5:
        b, f = tensors[0].shape[:2]
        cropped = _per_sample_random_crop([t.reshape(b * f, *t.shape[2:]) for t in tensors],
                                          crop_size, generator)
        return tuple(t.reshape(b, f, *t.shape[1:]) for t in cropped)
    b, h, w, _ = tensors[0].shape
    device = tensors[0].device
    tops = rows_of(lambda n: torch.randint(0, h - crop_size + 1, (n,), generator=generator,
                                           device=device), b)
    lefts = rows_of(lambda n: torch.randint(0, w - crop_size + 1, (n,), generator=generator,
                                            device=device), b)
    offsets = torch.arange(crop_size, device=device)
    rows = (tops[:, None] + offsets)[:, :, None]
    cols = (lefts[:, None] + offsets)[:, None, :]
    batch = torch.arange(b, device=device)[:, None, None]
    return tuple(t[batch, rows, cols] for t in tensors)


class Imagen(nn.Module):
    """Cascade of unets with their noise schedules. Keyword names mirror the
    JAX `Imagen` fields.

    Unets whose conditioning config the cascade must correct are rebuilt by
    `cast_model_parameters` with fresh weights: load weights after building
    the `Imagen`, or build each unet with the config it will have here
    (`lowres_cond=True` for every stage after the first). The cascade lives on
    `device` (None: the card; raises without one) and moves its unets there.

    A cascade with a video unet is a video cascade: `sample` needs
    `video_frames`, and stage i samples `video_frames //
    temporal_downsample_factor[i]` frames (the last factor must be 1);
    `forward` trains stage i on clips resized to that many frames.
    `resize_mode` is the `jax.image.resize` method of every resize;
    `resize_cond_video_frames=False` hands prompt frames to every stage
    unscaled in time.
    """

    def __init__(self, unets, *, image_sizes, text_encoder_name='google/t5-v1_1-base',
                 text_embed_dim=None, channels=3, timesteps=1000, cond_drop_prob=0.1,
                 loss_type='l2', noise_schedules='cosine', pred_objectives='noise',
                 random_crop_sizes=None, lowres_noise_schedule='linear',
                 lowres_sample_noise_level=0.2, per_sample_random_aug_noise_level=False,
                 condition_on_text=True, auto_normalize_img=True,
                 dynamic_thresholding=True, dynamic_thresholding_percentile=0.95,
                 only_train_unet_number=None, temporal_downsample_factor=1,
                 resize_mode='nearest', resize_cond_video_frames=True,
                 min_snr_loss_weight=True, min_snr_gamma=5, device=None):
        super().__init__()
        if loss_type not in LOSS_FNS:
            raise NotImplementedError(f'unknown loss type {loss_type}')
        resize_kernel(resize_mode)   # raises on an unknown method
        self.resize_mode = resize_mode
        self.resize_cond_video_frames = resize_cond_video_frames
        self.loss_type = loss_type
        self.loss_fn = LOSS_FNS[loss_type]
        unets = cast_tuple(unets)
        num_unets = len(unets)
        self.num_unets = num_unets
        self.channels = channels
        self.condition_on_text = condition_on_text
        self.unconditional = not condition_on_text
        self.text_encoder_name = text_encoder_name
        self.cond_drop_prob = cond_drop_prob
        self.can_classifier_guidance = cond_drop_prob > 0.
        self.lowres_sample_noise_level = lowres_sample_noise_level
        self.dynamic_thresholding_percentile = dynamic_thresholding_percentile

        timesteps = cast_tuple(timesteps, num_unets)
        noise_schedules = pad_tuple_to_length(cast_tuple(noise_schedules), 2, 'cosine')
        noise_schedules = pad_tuple_to_length(noise_schedules, num_unets, 'linear')
        self.noise_schedulers = tuple(
            GaussianDiffusionContinuousTimes(noise_schedule=sched, timesteps=ts)
            for ts, sched in zip(timesteps, noise_schedules))
        self.lowres_noise_schedule = GaussianDiffusionContinuousTimes(
            noise_schedule=lowres_noise_schedule)
        self.pred_objectives = cast_tuple(pred_objectives, num_unets)
        self.dynamic_thresholding = cast_tuple(dynamic_thresholding, num_unets)
        self.random_crop_sizes = cast_tuple(random_crop_sizes, num_unets)
        if exists(self.random_crop_sizes[0]):
            raise ValueError('random_crop_sizes should be None for the base unet '
                             '(e.g. (None, 128, 256))')
        self.per_sample_random_aug_noise_level = per_sample_random_aug_noise_level
        self.only_train_unet_number = only_train_unet_number
        self.min_snr_gamma = tuple(
            gamma if use else None for use, gamma in
            zip(cast_tuple(min_snr_loss_weight, num_unets), cast_tuple(min_snr_gamma, num_unets)))

        if condition_on_text and text_embed_dim is None:
            text_embed_dim = get_encoded_dim(text_encoder_name)
        self.text_embed_dim = text_embed_dim if condition_on_text else None

        self.unets = nn.ModuleList([
            unet.cast_model_parameters(
                lowres_cond=ind > 0, cond_on_text=condition_on_text,
                text_embed_dim=self.text_embed_dim, channels=channels,
                channels_out=channels)
            for ind, unet in enumerate(unets)])

        self.image_sizes = cast_tuple(image_sizes)
        if len(self.image_sizes) != num_unets:
            raise ValueError(f'{num_unets} unets do not match image_sizes {self.image_sizes}')

        self.is_video = any(getattr(u, 'is_video_unet', False) for u in self.unets)
        self.temporal_downsample_factor = cast_tuple(temporal_downsample_factor, num_unets)
        if self.temporal_downsample_factor[-1] != 1:
            raise ValueError('the last unet must sample every frame '
                             '(temporal_downsample_factor[-1] == 1)')

        self.normalize_img = normalize_neg_one_to_one if auto_normalize_img else (lambda t: t)
        self.unnormalize_img = unnormalize_zero_to_one if auto_normalize_img else (lambda t: t)
        self.input_image_range = (0. if auto_normalize_img else -1., 1.)
        # where sampling runs; unets parked elsewhere (`offload_inactive_unets`) do not move it
        self.register_buffer('_device_anchor', torch.zeros(0), persistent=False)
        self.to(resolve_device(device))

    @property
    def device(self):
        return self._device_anchor.device

    def get_unet(self, unet_number):
        """The unet of stage `unet_number`, counted from 1."""
        if not 0 < unet_number <= self.num_unets:
            raise ValueError(f'unet_number {unet_number} is not in 1..{self.num_unets}')
        return self.unets[unet_number - 1]

    def force_unconditional_(self):
        """Drop the text conditioning of the whole cascade in place: the
        cascade then samples and trains without text, as one built with
        `condition_on_text=False`. Each unet keeps its text modules and their
        weights, which its forward no longer reads, so a state_dict still
        loads strictly."""
        self.condition_on_text = False
        self.unconditional = True
        for unet in self.unets:
            if hasattr(unet, 'cond_on_text'):
                unet.cond_on_text = False
                unet._config['cond_on_text'] = False

    def encode_text(self, texts, **kwargs):
        """`texts` through the cascade's T5 encoder, on its device."""
        return t5_encode_text(texts, name=self.text_encoder_name, device=self.device, **kwargs)

    def resize_to(self, x, size, target_frames=None, clamp_range=None):
        """`resize_mode` resize of an NHWC image batch, or of NFHWC video
        (spatially and, with `target_frames`, in time) for a video cascade."""
        if self.is_video:
            return resize_video_to(x, size, target_frames=target_frames,
                                   clamp_range=clamp_range, method=self.resize_mode)
        return resize_image_to(x, size, clamp_range=clamp_range, method=self.resize_mode)

    def _prompt_frames(self, index, cond_video_frames, post_cond_video_frames):
        """The prompt-frame kwargs of stage `index`, each scaled in time
        (nearest, as in JAX) by the stage's temporal downsample factor, or
        unscaled with `resize_cond_video_frames=False`."""
        kwargs = {}
        for name, frames in (('cond_video_frames', cond_video_frames),
                             ('post_cond_video_frames', post_cond_video_frames)):
            if exists(frames):
                if not self.is_video:
                    raise ValueError(f'{name} needs a video cascade')
                frames = frames.to(self.device)
                if self.resize_cond_video_frames:
                    frames = scale_video_time(frames, self.temporal_downsample_factor[index])
                kwargs[name] = frames
        return kwargs

    def _calc_all_frame_dims(self, frames):
        """Frames sampled by each stage; None for an image cascade."""
        if frames is None:
            return (None,) * self.num_unets
        dims = []
        for divisor in self.temporal_downsample_factor:
            if frames % divisor:
                raise ValueError(f'frames {frames} not divisible by temporal factor {divisor}')
            dims.append(frames // divisor)
        return tuple(dims)

    # --- dynamic thresholding ------------------------------------------------------------

    def threshold_x_start(self, x_start, dynamic_threshold=True):
        """Static clamp, or the dynamic percentile threshold: torch.quantile's
        linear interpolation of |x_start| per image, between two exact order
        statistics (`ops.tensor_utils.nonneg_order_stats`)."""
        if not dynamic_threshold:
            return x_start.clamp(-1., 1.)
        flat = x_start.reshape(x_start.shape[0], -1)
        s = quantile_rows(flat, self.dynamic_thresholding_percentile).clamp(min=1.)
        s = right_pad_dims_to(x_start, s).to(x_start.dtype)
        return torch.maximum(torch.minimum(x_start, s), -s) / s

    # --- one denoising step --------------------------------------------------------------

    def p_mean_variance(self, unet, x, t, *, noise_scheduler, t_next=None, cond_scale=1.,
                        pred_objective='noise', dynamic_threshold=True, **unet_kwargs):
        if cond_scale != 1. and not self.can_classifier_guidance:
            raise ValueError('imagen was not trained with conditional dropout; '
                             'cannot use cond_scale != 1')
        pred = unet_forward_with_cond_scale(
            unet, x, noise_scheduler.get_condition(t), cond_scale=cond_scale, **unet_kwargs)

        if pred_objective == 'noise':
            x_start = noise_scheduler.predict_start_from_noise(x, t, pred)
        elif pred_objective == 'x_start':
            x_start = pred
        elif pred_objective == 'v':
            x_start = noise_scheduler.predict_start_from_v(x, t, pred)
        else:
            raise ValueError(f'unknown objective {pred_objective}')

        x_start = self.threshold_x_start(x_start, dynamic_threshold)
        return noise_scheduler.q_posterior(x_start=x_start, x_t=x, t=t, t_next=t_next), x_start

    def p_sample(self, unet, x, t, *, noise, noise_scheduler, t_next=None, cond_scale=1.,
                 pred_objective='noise', dynamic_threshold=True, **unet_kwargs):
        """One ancestral sampling step with the given step noise."""
        with span('sample.step'):
            (model_mean, _, model_log_variance), x_start = self.p_mean_variance(
                unet, x, t, noise_scheduler=noise_scheduler, t_next=t_next,
                cond_scale=cond_scale, pred_objective=pred_objective,
                dynamic_threshold=dynamic_threshold, **unet_kwargs)
            nonzero_mask = right_pad_dims_to(x, 1. - (t_next == 0).to(x.dtype))
            pred_img = model_mean + nonzero_mask * torch.exp(0.5 * model_log_variance) * noise
            return pred_img, x_start

    # --- one cascade stage ---------------------------------------------------------------

    def _sample_stage(self, index, *, batch_size, frames, cond_scale, unet_kwargs, noise,
                      generator, inpaint_images=None, inpaint_masks=None, resample_times=1,
                      init_images=None, skip_steps=0):
        """The ancestral sampler of one stage: (t, t_next) from the schedule,
        the first `skip_steps` pairs skipped, the initial noise plus
        `init_images`. Inpainting (RePaint): at each (t, r) the known region
        is pasted as `q_sample(inpaint_images, t)`, the step is taken, and
        unless r or t is the last, the image is renoised from t_next back to
        t; the known pixels are pasted exactly at the end. A unet with
        `self_cond` sees the previous step's x_start (zeros at the first).
        `noise` holds the draws that override `generator`'s (see `sample`)."""
        unet = self.unets[index]
        noise_scheduler = self.noise_schedulers[index]
        size = self.image_sizes[index]
        shape = (batch_size, *((frames,) if exists(frames) else ()), size, size, self.channels)
        device = self.device
        inpainting = exists(inpaint_images)
        t_arr, t_next_arr = noise_scheduler.get_sampling_timesteps(batch_size, device=device)
        t_arr, t_next_arr = t_arr[skip_steps:], t_next_arr[skip_steps:]
        steps = t_arr.shape[0]
        per_step = (steps, resample_times, *shape) if inpainting else (steps, *shape)
        check_draw_shapes(noise, index, init=shape, steps=per_step,
                        inpaint=(steps, resample_times, *shape),
                        renoise=(steps, resample_times, *shape))

        def draw(name, *at):
            if name in noise:
                return noise[name][at].to(device)
            return torch.randn(shape, generator=generator, device=device)

        img = draw('init')
        if exists(init_images):
            img = img + init_images
        x_start = torch.zeros_like(img)
        for i in range(steps):
            t, t_next = t_arr[i], t_next_arr[i]
            for r in range(resample_times):
                if inpainting:
                    known, *_ = noise_scheduler.q_sample(inpaint_images, t, draw('inpaint', i, r))
                    img = torch.where(inpaint_masks, known, img)
                self_cond = dict(self_cond=x_start) if unet.self_cond else {}
                img, x_start = self.p_sample(
                    unet, img, t, noise=draw('steps', *((i, r) if inpainting else (i,))),
                    t_next=t_next, noise_scheduler=noise_scheduler, cond_scale=cond_scale,
                    pred_objective=self.pred_objectives[index],
                    dynamic_threshold=self.dynamic_thresholding[index], **self_cond,
                    **unet_kwargs)
                if inpainting and r < resample_times - 1 and i < steps - 1:
                    img = noise_scheduler.q_sample_from_to(img, t_next, t, draw('renoise', i, r))
        img = img.clamp(-1., 1.)
        if inpainting:
            img = torch.where(inpaint_masks, inpaint_images, img)
        return self.unnormalize_img(img)

    # --- public sampling API -------------------------------------------------------------

    @staticmethod
    def _override_dict(entry):
        """A stage's `noise_override` entry as a dict of `_OVERRIDE_KEYS`."""
        if entry is None:
            return {}
        if isinstance(entry, (tuple, list)) and len(entry) == 3:
            entry = dict(zip(('init', 'steps', 'lowres'), entry))
        if not isinstance(entry, dict):
            raise ValueError('a noise_override entry is None, an (init, steps, lowres) tuple '
                             f'or a dict, got {type(entry).__name__}')
        return override_draws(entry, _OVERRIDE_KEYS)

    @torch.no_grad()
    def sample(self, *, texts=None, text_masks=None, text_embeds=None, batch_size=1,
               video_frames=None, cond_images=None, cond_video_frames=None,
               post_cond_video_frames=None, inpaint_videos=None, inpaint_images=None,
               inpaint_masks=None, inpaint_resample_times=5, init_images=None, skip_steps=None,
               cond_scale=1., lowres_sample_noise_level=None, start_at_unet_number=1,
               start_image_or_video=None, stop_at_unet_number=None,
               return_all_unet_outputs=False, return_pil_images=False,
               noise_override: Optional[Sequence] = None, offload_inactive_unets=False,
               use_tqdm=True, generator: Optional[torch.Generator] = None):
        """Run the cascade; returns the last stage's NHWC images, or NFHWC
        video of a video cascade, in [0, 1] (every stage's, a list, with
        `return_all_unet_outputs`; PIL images with `return_pil_images`, a
        list of frames per clip for video). `use_tqdm` shows a progress bar
        over the stages (none when tqdm is not installed).

        `offload_inactive_unets`: a unet parked off `self.device` (e.g.
        `imagen.unets[i].to('cpu')`) is copied to the device for its stage
        only and the copy dropped when the stage ends, so only the active
        stage's parameters sit on the card (JAX `offload_inactive_unets`).

        `cond_video_frames` / `post_cond_video_frames` (b, n, h, w, c) are
        prompt frames that every stage's unet sees before / after the frames
        it samples, scaled in time by the stage's temporal downsample factor.

        `cond_images` (b, h, w, c'), uint8 or float, go to every stage's unet
        (each built with `cond_images_channels`), which resizes them.
        `inpaint_images` (b, s, s, c) in the input range and `inpaint_masks`
        (b, s, s) bool, True where the pixels are known, inpaint with
        `inpaint_resample_times` RePaint resamples a step; a video cascade
        takes `inpaint_videos` (b, f, s, s, c) and a (b, s, s) mask repeats
        over the frames. Both are resized to each stage (the mask by
        nearest). `init_images` (one, or one per unet; None skips a stage)
        start the stage from noise + the normalised image, and `skip_steps`
        (one, or one per unet) drops the first steps of the schedule.
        `lowres_sample_noise_level` overrides the cascade's for this call.

        `noise_override`: per-stage list (len == num_unets, entries may be None)
        of draws used instead of `generator`'s; each with a frame axis after
        the batch, (b, f, s, s, c), for video. An entry is a tuple
        (init, steps, lowres), or a dict with any of the JAX draws:
        'init' (b, s, s, c), the initial noise; 'steps' (T, b, s, s, c), the
        ancestral step noise, or (T, R, b, s, s, c) when inpainting;
        'inpaint' (T, R, b, s, s, c), the noise of the pasted known region;
        'renoise' (T, R, b, s, s, c), RePaint's renoise from t_next to t
        (its last r and last step unused); 'lowres' (b, s, s, c), the low-res
        noise augmentation of stages after the first. The (T, R) draws are
        indexed [t, r] in JAX's draw order; T counts the steps left after
        `skip_steps` and R is `inpaint_resample_times`.
        """
        return self._sample_cascade(
            texts=texts, text_embeds=text_embeds, text_masks=text_masks, batch_size=batch_size,
            video_frames=video_frames, cond_images=cond_images,
            cond_video_frames=cond_video_frames, post_cond_video_frames=post_cond_video_frames,
            inpaint_images=default(inpaint_videos, inpaint_images), inpaint_masks=inpaint_masks,
            inpaint_resample_times=inpaint_resample_times, init_images=init_images,
            skip_steps=skip_steps, cond_scale=cond_scale,
            lowres_sample_noise_level=lowres_sample_noise_level,
            start_at_unet_number=start_at_unet_number,
            start_image_or_video=start_image_or_video, stop_at_unet_number=stop_at_unet_number,
            noise_override=noise_override, offload_inactive_unets=offload_inactive_unets,
            return_all_unet_outputs=return_all_unet_outputs,
            return_pil_images=return_pil_images, use_tqdm=use_tqdm, generator=generator)

    def _sample_cascade(self, *, texts, text_embeds, text_masks, batch_size, video_frames,
                        cond_images, cond_video_frames, post_cond_video_frames, inpaint_images,
                        inpaint_masks, inpaint_resample_times, init_images, skip_steps,
                        cond_scale, lowres_sample_noise_level, start_at_unet_number,
                        start_image_or_video, stop_at_unet_number, noise_override, generator,
                        return_all_unet_outputs=False, return_pil_images=False,
                        offload_inactive_unets=False, use_tqdm=True, **stage_options):
        """The stage loop of `sample`, which the EDM sampler shares: checks the
        text, the inpainting inputs and the frames, then for each stage builds
        the unet's conditioning (text, cond images, prompt frames, the noised
        low-res image of the stage before), resizes the init and inpainting
        images and the masks to it and calls `self._sample_stage`, with
        `noise_override[index]` (made a dict by `self._override_dict`) less
        its 'lowres' draw as `noise` and `stage_options` passed through, the
        unet in eval mode; `use_tqdm` wraps the stage loop in a progress bar."""
        with span('sample'):
            if exists(texts) and not exists(text_embeds) and not self.unconditional:
                text_embeds, text_masks = self.encode_text(texts, return_attn_mask=True)
            device = self.device
            if not self.unconditional:
                if not exists(text_embeds):
                    raise ValueError('text embeddings must be passed to a conditional imagen')
                text_embeds = text_embeds.to(device)
                text_masks = (text_embeds != 0.).any(dim=-1) if text_masks is None \
                    else text_masks.to(device)
                batch_size = text_embeds.shape[0]
                if text_embeds.shape[-1] != self.text_embed_dim:
                    raise ValueError(f'text embeddings of dim {text_embeds.shape[-1]}, '
                                     f'expected {self.text_embed_dim}')
            elif exists(text_embeds):
                raise ValueError('unconditional imagen cannot take text embeddings')

            inpainting = exists(inpaint_images)
            if inpainting != exists(inpaint_masks):
                raise ValueError('inpaint_images and inpaint_masks go together')
            resample_times = inpaint_resample_times if inpainting else 1
            if inpainting:
                inpaint_images, inpaint_masks = inpaint_images.to(device), inpaint_masks.to(device)
                if self.unconditional and batch_size == 1:
                    batch_size = inpaint_images.shape[0]
                if self.is_video:
                    video_frames = inpaint_images.shape[1]
                    if inpaint_masks.ndim == 3:   # one mask for every frame
                        inpaint_masks = inpaint_masks[:, None].expand(-1, video_frames, -1, -1)
                    if inpaint_masks.shape[1] != video_frames:
                        raise ValueError(f'inpaint masks of {inpaint_masks.shape[1]} frames for '
                                         f'{video_frames} frames of video')
            if self.is_video and not exists(video_frames):
                raise ValueError('video_frames must be passed for a video imagen')
            if exists(cond_images):
                cond_images = cast_uint8_images_to_float(cond_images.to(device))

            all_frame_dims = self._calc_all_frame_dims(video_frames if self.is_video else None)
            num_unets = self.num_unets
            cond_scale = cast_tuple(cond_scale, num_unets)
            init_images = [None if im is None else self.normalize_img(im.to(device))
                           for im in cast_tuple(init_images, num_unets)]
            skip_steps = cast_tuple(default(skip_steps, 0), num_unets)
            lowres_sample_noise_level = default(lowres_sample_noise_level,
                                                self.lowres_sample_noise_level)
            noise_override = default(noise_override, (None,) * num_unets)
            if len(noise_override) != num_unets:
                raise ValueError('noise_override must be a per-stage list (entries may be None)')

            img = None
            if start_at_unet_number > 1:
                if not exists(start_image_or_video):
                    raise ValueError('starting image must be supplied if only doing upscaling')
                img = self.resize_to(start_image_or_video.to(device),
                                     self.image_sizes[start_at_unet_number - 2],
                                     target_frames=all_frame_dims[start_at_unet_number - 2])

            outputs = []
            stages = range(start_at_unet_number, num_unets + 1)
            for unet_number in stage_progress(stages, enabled=use_tqdm, desc='sampling cascade',
                                              total=len(stages)):
                index = unet_number - 1
                unet = self.unets[index]
                if isinstance(unet, NullUnet):
                    raise ValueError('cannot sample from a NullUnet')
                image_size = self.image_sizes[index]
                frames = all_frame_dims[index]
                noise = self._override_dict(noise_override[index])
                lowres_noise = noise.pop('lowres', None)

                unet_kwargs = self._prompt_frames(index, cond_video_frames, post_cond_video_frames)
                if not self.unconditional:
                    unet_kwargs.update(text_embeds=text_embeds, text_mask=text_masks)
                if exists(cond_images):
                    unet_kwargs.update(cond_images=cond_images)
                if unet.lowres_cond:
                    lowres_noise_times = self.lowres_noise_schedule.get_times(
                        batch_size, lowres_sample_noise_level, device=device)
                    lowres_cond_img = self.normalize_img(self.resize_to(
                        img, image_size, target_frames=frames))
                    if exists(lowres_noise):
                        if lowres_noise.shape != lowres_cond_img.shape:
                            raise ValueError(f'low-res noise of stage {unet_number} is '
                                             f'{tuple(lowres_noise.shape)}, expected '
                                             f'{tuple(lowres_cond_img.shape)}')
                        lowres_noise = lowres_noise.to(device)
                    else:
                        lowres_noise = torch.randn(lowres_cond_img.shape, generator=generator,
                                                   device=device)
                    lowres_cond_img, *_ = self.lowres_noise_schedule.q_sample(
                        lowres_cond_img, lowres_noise_times, lowres_noise)
                    unet_kwargs.update(
                        lowres_cond_img=lowres_cond_img,
                        lowres_noise_times=self.lowres_noise_schedule.get_condition(
                            lowres_noise_times))

                stage_init = init_images[index]
                if exists(stage_init):
                    stage_init = self.resize_to(stage_init, image_size, target_frames=frames)
                stage_inpaint = stage_masks = None
                if inpainting:
                    stage_inpaint = self.normalize_img(
                        self.resize_to(inpaint_images, image_size, target_frames=frames))
                    stage_masks = self.resize_to(inpaint_masks[..., None].float(), image_size,
                                                 target_frames=frames).bool()

                with on_device(unet, device) if offload_inactive_unets else nullcontext(), \
                        unet_mode(unet, False):
                    img = self._sample_stage(
                        index, batch_size=batch_size, frames=frames, cond_scale=cond_scale[index],
                        unet_kwargs=unet_kwargs, noise=noise, generator=generator,
                        inpaint_images=stage_inpaint, inpaint_masks=stage_masks,
                        resample_times=resample_times, init_images=stage_init,
                        skip_steps=skip_steps[index], **stage_options)
                outputs.append(img)

                if exists(stop_at_unet_number) and stop_at_unet_number == unet_number:
                    break

            if return_pil_images:
                outputs = [to_pil_images(out, self.is_video) for out in outputs]
            return outputs if return_all_unet_outputs else outputs[-1]

    # --- training loss ---------------------------------------------------------------------

    def p_losses(self, unet, x_start, times, *, noise_scheduler, lowres_cond_img=None,
                 lowres_aug_times=None, text_embeds=None, text_mask=None, cond_images=None,
                 noise=None, lowres_aug_noise=None, self_cond_flip=None, pred_objective='noise',
                 min_snr_gamma=None, random_crop_size=None, generator=None, **unet_kwargs):
        """Denoising loss of one unet on a batch of images (NHWC) or clips
        (NFHWC) in the input range.

        `noise` and `lowres_aug_noise` (the low-res condition's augmentation
        noise, after any crop) are drawn from `generator` when not given, as
        are the crop offsets, the text drop of classifier-free guidance and
        the dropout masks of the unet, which runs in train mode.
        `cond_images` go to the unet uncropped, as in the JAX package. A unet
        with `self_cond` is given, half of the time (a fair coin from
        `generator`, or `self_cond_flip`), the x_start of a first forward
        without gradient, else zeros. `unet_kwargs` (a video unet's
        `ignore_time`, `cond_video_frames`, `post_cond_video_frames`) pass
        through to the unet.
        """
        def randn(shape, dtype):
            return rows_of(lambda n: torch.randn((n, *shape[1:]), generator=generator,
                                                 device=x_start.device, dtype=dtype), shape[0])

        noise = default(noise, lambda: randn(x_start.shape, x_start.dtype))
        x_start = self.normalize_img(x_start)
        if exists(lowres_cond_img):
            lowres_cond_img = self.normalize_img(lowres_cond_img)

        if exists(random_crop_size):
            tensors = (x_start, noise) + ((lowres_cond_img,) if exists(lowres_cond_img) else ())
            x_start, noise, *rest = _per_sample_random_crop(tensors, random_crop_size, generator)
            if exists(lowres_cond_img):
                lowres_cond_img = rest[0]

        x_noisy, log_snr, *_ = noise_scheduler.q_sample(x_start, times, noise)

        lowres_cond_img_noisy = None
        if exists(lowres_cond_img):
            lowres_aug_times = default(lowres_aug_times, times)
            lowres_aug_noise = default(
                lowres_aug_noise, lambda: randn(lowres_cond_img.shape, lowres_cond_img.dtype))
            lowres_cond_img_noisy, *_ = self.lowres_noise_schedule.q_sample(
                lowres_cond_img, lowres_aug_times, lowres_aug_noise)

        noise_cond = noise_scheduler.get_condition(times)
        unet_kwargs.update(
            text_embeds=text_embeds, text_mask=text_mask, lowres_cond_img=lowres_cond_img_noisy,
            lowres_noise_times=self.lowres_noise_schedule.get_condition(lowres_aug_times),
            cond_drop_prob=self.cond_drop_prob, generator=generator)
        if exists(cond_images):
            unet_kwargs['cond_images'] = cond_images
        if unet.self_cond:
            if self_cond_flip is None:
                self_cond_flip = bool(torch.rand((), generator=generator,
                                                 device=x_start.device) < 0.5)
            self_cond = torch.zeros_like(x_noisy)
            if self_cond_flip:
                with torch.no_grad(), unet_mode(unet, True):
                    first = unet(x_noisy, noise_cond, **unet_kwargs)
                    # x_start for the noise objective, else the prediction, as in JAX
                    self_cond = (noise_scheduler.predict_start_from_noise(x_noisy, times, first)
                                 if pred_objective == 'noise' else first).detach()
            unet_kwargs['self_cond'] = self_cond

        with unet_mode(unet, True):
            pred = unet(x_noisy, noise_cond, **unet_kwargs)

        if pred_objective == 'noise':
            target = noise
        elif pred_objective == 'x_start':
            target = x_start
        elif pred_objective == 'v':
            target = noise_scheduler.predict_v_from_start_and_noise(x_start, times, noise)
        else:
            raise ValueError(f'unknown objective {pred_objective}')

        losses = self.loss_fn(pred.float(), target.float())
        losses = losses.reshape(losses.shape[0], -1).mean(dim=-1)

        # min-SNR loss weighting (arXiv 2303.09556)
        snr = torch.exp(log_snr.float())
        clipped_snr = snr.clamp(max=min_snr_gamma) if exists(min_snr_gamma) else snr
        if pred_objective == 'noise':
            loss_weight = clipped_snr / snr
        elif pred_objective == 'x_start':
            loss_weight = clipped_snr
        else:
            loss_weight = clipped_snr / (snr + 1)
        return (losses * loss_weight).mean()

    def _training_batch(self, images, *, unet_number, texts, text_embeds, text_masks,
                        cond_images, cond_video_frames, post_cond_video_frames, ignore_time):
        """What both training losses (DDPM's `forward` and EDM's) take from a
        batch, with no random draw: checks the unet number and the inputs,
        makes uint8 images float, turns still images into one-frame clips
        with `ignore_time` for a video cascade, and returns a `TrainingBatch`:
        the images resized to the stage (and its frames), the degraded
        low-res condition (resized down to the stage before and back up, in
        space and, for video, in time), and the unet's conditioning (text
        embeds and mask, cond images, scaled prompt frames, `ignore_time`)."""
        if self.num_unets > 1 and not exists(unet_number):
            raise ValueError(f'specify unet_number in [1, {self.num_unets}] for a cascade')
        unet_number = default(unet_number, 1)
        if exists(self.only_train_unet_number) and self.only_train_unet_number != unet_number:
            raise ValueError(f'only unet {self.only_train_unet_number} may be trained')
        if exists(texts) and not exists(text_embeds) and not self.unconditional:
            text_embeds, text_masks = self.encode_text(texts, return_attn_mask=True)
        index = unet_number - 1
        if isinstance(self.unets[index], NullUnet):
            raise ValueError('a NullUnet cannot be trained')

        device = self.device
        images = cast_uint8_images_to_float(images.to(device))
        if exists(cond_images):
            cond_images = cast_uint8_images_to_float(cond_images.to(device))
        if self.is_video and images.ndim == 4:   # still images: one-frame clips
            images, ignore_time = images[:, None], True
        if images.ndim != (5 if self.is_video else 4) or images.shape[-2] != images.shape[-3] \
                or images.shape[-1] != self.channels:
            raise ValueError(f'{"clips" if self.is_video else "images"} must be square with '
                             f'{self.channels} channels, got {tuple(images.shape)}')
        target_size = self.image_sizes[index]
        if images.shape[-2] < target_size:
            raise ValueError(f'images of {images.shape[-2]} px are smaller than {target_size}')

        # per-stage frame counts; None keeps a clip's frames (images, ignore_time)
        frame_dims = (self._calc_all_frame_dims(images.shape[1])
                      if self.is_video and not ignore_time else (None,) * self.num_unets)
        cond = self._prompt_frames(index, cond_video_frames, post_cond_video_frames)
        if self.is_video:
            cond['ignore_time'] = ignore_time

        if not self.unconditional:
            if not exists(text_embeds):
                raise ValueError('text embeddings must be passed to a conditional imagen')
            text_embeds = text_embeds.to(device)
            if text_embeds.shape[-1] != self.text_embed_dim:
                raise ValueError(f'text embeddings of dim {text_embeds.shape[-1]}, '
                                 f'expected {self.text_embed_dim}')
            text_masks = (text_embeds != 0.).any(dim=-1) if text_masks is None \
                else text_masks.to(device)
        elif exists(text_embeds):
            raise ValueError('unconditional imagen cannot take text embeddings')
        cond.update(text_embeds=text_embeds, text_mask=text_masks, cond_images=cond_images)

        lowres_cond_img = None
        if index > 0:
            lowres_cond_img = self.resize_to(images, self.image_sizes[index - 1],
                                             target_frames=frame_dims[index - 1],
                                             clamp_range=self.input_image_range)
            lowres_cond_img = self.resize_to(lowres_cond_img, target_size,
                                             target_frames=frame_dims[index],
                                             clamp_range=self.input_image_range)
        images = self.resize_to(images, target_size, target_frames=frame_dims[index])
        return TrainingBatch(index, images, lowres_cond_img, cond)

    def _lowres_aug_times(self, batch_size, generator):
        """The low-res condition's augmentation times: one draw for the batch,
        or one per sample with `per_sample_random_aug_noise_level`."""
        if self.per_sample_random_aug_noise_level:
            return rows_of(lambda n: self.lowres_noise_schedule.sample_random_times(
                n, generator, self.device), batch_size)
        return self.lowres_noise_schedule.sample_random_times(
            1, generator, self.device).expand(batch_size)

    def forward(self, images, *, unet_number=None, texts=None, text_embeds=None,
                text_masks=None, cond_images=None, cond_video_frames=None,
                post_cond_video_frames=None, ignore_time=False, generator=None):
        """Training loss of unet `unet_number` on a batch of NHWC images, or
        of NFHWC clips for a video cascade, in [0, 1] (or uint8), drawing
        every random value from `generator`. `cond_images` (uint8 or float)
        go to the unet as they are (it resizes them).

        A video cascade trains stage i on clips resized to its frame count
        (`video_frames // temporal_downsample_factor[i]`); still images
        train it as one-frame clips with `ignore_time`, which skips every
        temporal module. Prompt frames are scaled in time as in `sample`.
        """
        batch = self._training_batch(
            images, unet_number=unet_number, texts=texts, text_embeds=text_embeds,
            text_masks=text_masks, cond_images=cond_images, cond_video_frames=cond_video_frames,
            post_cond_video_frames=post_cond_video_frames, ignore_time=ignore_time)
        index = batch.index
        noise_scheduler = self.noise_schedulers[index]
        b = batch.images.shape[0]
        times = rows_of(lambda n: noise_scheduler.sample_random_times(n, generator, self.device),
                        b)
        lowres_aug_times = (self._lowres_aug_times(b, generator)
                            if exists(batch.lowres_cond_img) else None)
        return self.p_losses(
            self.unets[index], batch.images, times, noise_scheduler=noise_scheduler,
            lowres_cond_img=batch.lowres_cond_img, lowres_aug_times=lowres_aug_times,
            pred_objective=self.pred_objectives[index], min_snr_gamma=self.min_snr_gamma[index],
            random_crop_size=self.random_crop_sizes[index], generator=generator, **batch.cond)
