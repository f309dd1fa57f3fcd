"""Data pipeline: a folder image dataset, the HF-dataset collator and the
loaders; counterpart of `imagen_tpu/data.py`.

Images are NHWC float32 in [0, 1], as in the JAX package. `DataLoader` is
`torch.utils.data.DataLoader` over a batch sampler that keeps the JAX
loader's order and its two rules: a dataset smaller than `batch_size`
still yields its one partial batch under `drop_last` (torch's own loader
yields none, and `cycle` would then raise), so `len()` is never 0 for a
non-empty dataset; and a batch the collator drops (None) is skipped.
Shuffling draws from `random.Random(seed)` as the JAX loader does, and
`split_dataset` shuffles with it too, so both packages pick the same
validation rows. `num_workers` defaults to 0; batches are made on the host
and no worker touches CUDA (the collator's T5 runs on the CPU unless it is
given another device).
"""
from __future__ import annotations

import random
from pathlib import Path

import numpy as np
import torch
import torch.utils.data

from imagen_tpu_torch.utils.helpers import default, exists, resolve_device


def cycle(dl):
    """Iterate `dl` forever; raises if a pass over it yields nothing."""
    while True:
        yielded = False
        for data in dl:
            yielded = True
            yield data
        if not yielded:
            raise ValueError('dataloader yielded no batches - is the dataset empty?')


def convert_image_to(img_type, image):
    if image.mode != img_type:
        return image.convert(img_type)
    return image


def resize_and_center_crop(img, image_size):
    """Resize the shortest side to `image_size` (bilinear), then center-crop a
    square: torchvision's Resize + CenterCrop."""
    from PIL import Image
    w, h = img.size
    scale = image_size / min(w, h)
    img = img.resize((max(image_size, round(w * scale)), max(image_size, round(h * scale))),
                     Image.BILINEAR)
    w, h = img.size
    left, top = (w - image_size) // 2, (h - image_size) // 2
    return img.crop((left, top, left + image_size, top + image_size))


def _to_array(img):
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return arr[..., None] if arr.ndim == 2 else arr


class Dataset(torch.utils.data.Dataset):
    """The images under `folder` (sorted by path), resized, center-cropped and
    randomly flipped; each item a (size, size, c) float32 tensor in [0, 1].
    JPEGs take the native decoder (`imagen_tpu_torch.native`) where it builds
    and no conversion is asked for, else PIL."""

    def __init__(self, folder, image_size, exts=('jpg', 'jpeg', 'png', 'tiff'),
                 convert_image_to_type=None, random_flip=True, seed=None, use_native=True):
        super().__init__()
        self.folder = folder
        self.image_size = image_size
        self.paths = sorted(p for ext in exts for p in Path(folder).glob(f'**/*.{ext}'))
        self.convert_image_to_type = convert_image_to_type
        self.random_flip = random_flip
        self._rng = random.Random(seed)
        self.use_native = use_native

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index):
        return torch.from_numpy(self._load(self.paths[index]))

    def _load(self, path):
        from PIL import Image
        if (self.use_native and path.suffix.lower() in ('.jpg', '.jpeg')
                and self.convert_image_to_type in (None, 'RGB')):
            from imagen_tpu_torch import native
            if native.available():
                hflip = self.random_flip and self._rng.random() < 0.5
                arr = native.jpeg_decode_resize(path.read_bytes(), self.image_size, hflip=hflip)
                if arr is not None:
                    return arr

        img = Image.open(path)
        if exists(self.convert_image_to_type):
            img = convert_image_to(self.convert_image_to_type, img)
        elif img.mode != 'RGB':
            img = img.convert('RGB')
        img = resize_and_center_crop(img, self.image_size)
        if self.random_flip and self._rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        return _to_array(img)


class Collator:
    """Collates HF-dataset rows: the image (fetched by URL with `url_label`),
    resized and center-cropped; the caption encoded by T5; rows that fail
    are dropped, and a batch with none left is None. Gives dict batches
    (images, text_embeds, text_masks) of tensors on `device`.

    T5 is loaded here, onto `device` unless it is cached already, so that a
    loader's workers, forked later, find it in place. Leave `device` on the
    CPU when the loader has workers: a worker must not touch CUDA, so T5
    must not be on the card before a worker is forked."""

    def __init__(self, image_size, url_label=None, text_label=None, image_label=None,
                 name=None, channels='RGB', device='cpu'):
        from imagen_tpu_torch.models.t5 import DEFAULT_T5_NAME, get_model_and_tokenizer
        self.url_label = url_label
        self.text_label = text_label
        self.image_label = image_label
        self.download = url_label is not None
        self.name = default(name, DEFAULT_T5_NAME)
        self.image_size = image_size
        self.channels = channels
        self.device = resolve_device(device)
        get_model_and_tokenizer(self.name, self.device)

    def __call__(self, batch):
        from imagen_tpu_torch.models.t5 import t5_encode_text
        texts, images = [], []
        for item in batch:
            image = (self.fetch_single_image(item[self.url_label]) if self.download
                     else item[self.image_label])
            image = self.transform_image(image)
            if image is None:
                continue
            images.append(image)
            texts.append(item[self.text_label])
        if not images:
            return None
        encoded = t5_encode_text(texts, name=self.name, device=self.device)
        images = torch.from_numpy(np.stack(images)).to(self.device)
        return dict(images=images, text_embeds=encoded,
                    text_masks=(encoded != 0.).any(dim=-1))

    def transform_image(self, image):
        """(size, size, c) float32 in [0, 1], or None for an image that does
        not decode."""
        import io
        from PIL import Image, UnidentifiedImageError
        if image is None:
            return None
        try:
            if isinstance(image, (bytes, bytearray)):
                image = Image.open(io.BytesIO(image))
            image = image.convert(self.channels)
            return _to_array(resize_and_center_crop(image, self.image_size))
        except (OSError, ValueError, UnidentifiedImageError):
            return None

    def fetch_single_image(self, image_url, timeout=1):
        import io
        import urllib.request
        from PIL import Image
        request = urllib.request.Request(
            image_url, data=None,
            headers={'user-agent': 'imagen-tpu/0 (fetching images for training)'})
        try:
            with urllib.request.urlopen(request, timeout=timeout) as req:
                return Image.open(io.BytesIO(req.read()))
        except (OSError, ValueError):
            return None


def split_dataset(ds, train_fraction, seed=42):
    """Random train / valid split: the rows shuffled by `random.Random(seed)`,
    the first `int(train_fraction * n)` for training."""
    n = len(ds)
    indices = list(range(n))
    random.Random(seed).shuffle(indices)
    train_size = int(train_fraction * n)
    return (torch.utils.data.Subset(ds, indices[:train_size]),
            torch.utils.data.Subset(ds, indices[train_size:]))


def _default_collate(items):
    """Stack items into a batch: dicts by key, tuples by position, arrays and
    tensors into one tensor."""
    first = items[0]
    if isinstance(first, dict):
        return {k: _default_collate([it[k] for it in items]) for k in first}
    if isinstance(first, (tuple, list)):
        return tuple(_default_collate(list(col)) for col in zip(*items))
    return torch.stack([torch.as_tensor(np.asarray(it)) if not isinstance(it, torch.Tensor)
                        else it for it in items])


class _JaxOrderBatches(torch.utils.data.Sampler):
    """The JAX loader's batches of indices: shuffled by `random.Random(seed)`,
    a trailing partial batch dropped under `drop_last` unless it is the only one."""

    def __init__(self, n, batch_size, shuffle, drop_last, seed):
        self.n, self.batch_size = n, batch_size
        self.shuffle, self.drop_last = shuffle, drop_last
        self._rng = random.Random(seed)

    def __len__(self):
        if self.drop_last:
            return max(self.n // self.batch_size, 1 if self.n else 0)
        return (self.n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        indices = list(range(self.n))
        if self.shuffle:
            self._rng.shuffle(indices)
        for start in range(0, self.n, self.batch_size):
            chunk = indices[start:start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size and start > 0:
                break
            yield chunk


class DataLoader(torch.utils.data.DataLoader):
    """`torch.utils.data.DataLoader` with the JAX loader's batching (see the
    module docstring); batches the collator drops are skipped."""

    def __init__(self, dataset, *, batch_size, shuffle=True, drop_last=True, collate_fn=None,
                 seed=None, num_workers=0, **kwargs):
        super().__init__(dataset,
                         batch_sampler=_JaxOrderBatches(len(dataset), batch_size, shuffle,
                                                        drop_last, seed),
                         collate_fn=collate_fn if collate_fn is not None else _default_collate,
                         num_workers=num_workers, **kwargs)

    def __iter__(self):
        for batch in super().__iter__():
            if batch is not None:
                yield batch


class PrefetchLoader:
    """Wraps a loader with a background thread that keeps `prefetch` batches
    ready, so host-side decoding overlaps the device's work."""

    def __init__(self, dl, prefetch: int = 2):
        self.dl = dl
        self.prefetch = prefetch

    def __len__(self):
        return len(self.dl)

    def __iter__(self):
        import queue
        import threading

        q = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        failure = []

        def producer():
            try:
                for item in self.dl:
                    q.put(item)
            except Exception as e:   # handed to the consumer, raised there
                failure.append(e)
            finally:
                q.put(sentinel)

        threading.Thread(target=producer, daemon=True).start()
        while (item := q.get()) is not sentinel:
            yield item
        if failure:
            raise failure[0]


def get_images_dataloader(folder, *, batch_size, image_size, shuffle=True, cycle_dl=False,
                          pin_memory=True, prefetch=2, **kwargs):
    """A loader over `Dataset(folder, image_size, **kwargs)`, prefetched by a
    thread and, with `cycle_dl`, endless; host memory pinned when a card is
    there to copy to."""
    ds = Dataset(folder, image_size, **kwargs)
    dl = DataLoader(ds, batch_size=batch_size, shuffle=shuffle,
                    pin_memory=pin_memory and torch.cuda.is_available())
    if prefetch:
        dl = PrefetchLoader(dl, prefetch=prefetch)
    if cycle_dl:
        dl = cycle(dl)
    return dl
