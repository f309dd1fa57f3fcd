"""Video export: sampled (f, h, w, c) clips to gif, mp4 or npy files;
counterpart of `imagen_tpu/utils/video_io.py`.

The format follows the file's extension:
- .gif: PIL;
- .mp4 / .webm / .mkv / .avi: imageio with its ffmpeg backend, where
  installed (else it raises, naming .gif and .npy);
- .npy: the raw array.
Clips may be tensors (on any device) or arrays, float in [0, 1] or uint8.
"""
from __future__ import annotations

import numpy as np
import torch


def _as_numpy(video):
    if isinstance(video, torch.Tensor):
        return video.detach().float().cpu().numpy() if video.dtype != torch.uint8 \
            else video.cpu().numpy()
    return np.asarray(video)


def _to_uint8_frames(video):
    """(f, h, w, c) float in [0, 1] or uint8 -> uint8 frames."""
    video = _as_numpy(video)
    if video.ndim != 4:
        raise ValueError(f'expected (frames, h, w, c), got {video.shape}')
    if video.dtype != np.uint8:
        video = (np.clip(video, 0., 1.) * 255).round().astype(np.uint8)
    return video


def video_tensor_to_pil_frames(video):
    """One PIL image per frame of a (f, h, w, c) clip."""
    from PIL import Image
    frames = _to_uint8_frames(video)
    if frames.shape[-1] == 1:
        frames = frames[..., 0]
    return [Image.fromarray(f) for f in frames]


def save_video(video, path, fps: int = 8):
    """Write one (f, h, w, c) clip to `path`; returns the path."""
    path = str(path)
    ext = path.rsplit('.', 1)[-1].lower() if '.' in path else ''

    if ext == 'npy':
        np.save(path, _as_numpy(video))
        return path

    if ext == 'gif':
        frames = video_tensor_to_pil_frames(video)
        frames[0].save(path, save_all=True, append_images=frames[1:],
                       duration=max(1, round(1000 / fps)), loop=0)
        return path

    if ext in ('mp4', 'webm', 'mkv', 'avi'):
        try:
            import imageio
            writer = imageio.get_writer(path, fps=fps)
        except (ImportError, ValueError, RuntimeError) as e:   # no imageio or no ffmpeg
            raise RuntimeError(f'cannot write .{ext} (imageio/ffmpeg unavailable: {e}); '
                               f'use .gif or .npy instead') from e
        with writer:
            for frame in _to_uint8_frames(video):
                writer.append_data(frame)
        return path

    raise ValueError(f'unknown video extension {ext!r} for {path}; use .gif, .mp4, or .npy')


def save_videos(videos, path_template, fps: int = 8):
    """Write a batch (b, f, h, w, c), clip i to `path_template.format(i)`;
    returns the paths."""
    return [save_video(v, path_template.format(i), fps=fps) for i, v in enumerate(videos)]
