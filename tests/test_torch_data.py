"""The port's data pipeline (`imagen_tpu_torch.data`, `.native`) against the
JAX package's, on the CPU.

- `Dataset` over a seeded folder of JPEGs and PNGs with random flips from one
  seed: the native JPEG route gives the same bits as the JAX package's
  native decoder, the PIL route the same arrays as the JAX PIL route;
- `split_dataset` picks the same rows, `DataLoader` yields the JAX loader's
  batches in its order (shuffled from the same seed), a dataset smaller than
  the batch still yields its one batch under `drop_last`, and batches the
  collator drops are skipped; `cycle` raises on an empty loader;
- `Collator` over HF-style rows with the same tiny random T5 injected into
  both packages: the same images, masks and embeddings (1e-5); encoding for
  an imagen and then for a collator never moves the one cached T5;
- `PrefetchLoader` and `get_images_dataloader`.
"""
import numpy as np
import pytest
import torch
from PIL import Image

from torch_port_bridge import TINY_T5, StandInEncoder, inject_t5, max_abs, rng, tiny_t5

import imagen_tpu.data as jdata
from imagen_tpu import native as jnative

import imagen_tpu_torch as it
from imagen_tpu_torch import data, native
from imagen_tpu_torch.models import t5


@pytest.fixture(scope='module')
def folder(tmp_path_factory):
    """Six seeded images of odd sizes: four JPEGs (one grey) and two PNGs."""
    root = tmp_path_factory.mktemp('images')
    r = rng(0)
    sizes = [(20, 24), (33, 17), (16, 16), (40, 28), (19, 31), (24, 24)]
    for i, (h, w) in enumerate(sizes):
        pixels = (r.rand(h, w, 3) * 255).astype(np.uint8)
        img = Image.fromarray(pixels)
        if i == 2:
            img = img.convert('L')
        if i < 4:
            img.save(root / f'img_{i}.jpg', quality=90)
        else:
            img.save(root / f'img_{i}.png')
    return root


@pytest.mark.parametrize('use_native', [True, False])
def test_dataset_matches_jax(folder, use_native):
    if use_native:
        assert native.available() and jnative.available()
    ds = data.Dataset(str(folder), image_size=12, seed=3, use_native=use_native)
    jds = jdata.Dataset(str(folder), image_size=12, seed=3, use_native=use_native)
    assert len(ds) == len(jds) == 6
    assert [p.name for p in ds.paths] == [p.name for p in jds.paths]
    for i in range(len(ds)):
        mine, ref = ds[i], jds[i]
        assert isinstance(mine, torch.Tensor) and mine.dtype == torch.float32
        assert mine.shape == (12, 12, 3) and 0. <= float(mine.min()) <= float(mine.max()) <= 1.
        np.testing.assert_array_equal(mine.numpy(), ref)


def test_native_batch_decode_matches_jax(folder):
    blobs = [p.read_bytes() for p in sorted(folder.glob('*.jpg'))] + [b'not a jpeg']
    flips = [True, False, True, False, True]
    out, ok = native.jpeg_decode_resize_batch(blobs, 10, hflips=flips, num_threads=2)
    jout, jok = jnative.jpeg_decode_resize_batch(blobs, 10, hflips=flips, num_threads=2)
    assert ok.tolist() == jok.tolist() == [True, True, True, True, False]
    np.testing.assert_array_equal(out[ok], jout[jok])
    assert native.jpeg_decode_resize(b'not a jpeg', 10) is None


def test_split_dataset_picks_the_jax_rows():
    rows = list(range(37))
    for fraction, seed in ((0.75, 42), (0.975, 7), (0.5, 0)):
        train, valid = data.split_dataset(rows, fraction, seed=seed)
        jtrain, jvalid = jdata.split_dataset(rows, fraction, seed=seed)
        assert list(train.indices) == jtrain.indices and list(valid.indices) == jvalid.indices
        assert [train[i] for i in range(len(train))] == [jtrain[i] for i in range(len(jtrain))]


def _items(n, seed=1):
    r = rng(seed)
    return [(r.rand(4, 4, 3).astype(np.float32), r.randn(5, 8).astype(np.float32))
            for _ in range(n)]


@pytest.mark.parametrize('n, batch, drop_last', [(10, 4, True), (10, 4, False), (3, 4, True),
                                                 (8, 4, True)])
def test_loader_yields_the_jax_batches(n, batch, drop_last):
    items = _items(n)
    dl = data.DataLoader(items, batch_size=batch, shuffle=True, drop_last=drop_last, seed=5)
    jdl = jdata.DataLoader(items, batch_size=batch, shuffle=True, drop_last=drop_last, seed=5)
    assert len(dl) == len(jdl) >= 1
    for _ in range(2):   # a second epoch reshuffles the same way
        got, ref = list(dl), list(jdl)
        assert len(got) == len(ref) == len(dl)
        for (images, embeds), (jimages, jembeds) in zip(got, ref):
            assert isinstance(images, torch.Tensor) and images.shape[1:] == (4, 4, 3)
            np.testing.assert_array_equal(images.numpy(), jimages)
            np.testing.assert_array_equal(embeds.numpy(), jembeds)


def test_tiny_split_still_batches_where_torch_would_not():
    """A validation split smaller than the batch: torch's own loader yields
    nothing under drop_last (and `cycle` would raise); the port's yields the
    JAX loader's one partial batch."""
    rows = _items(5)
    _, valid = data.split_dataset(rows, 0.75, seed=42)
    assert len(valid) == 2
    assert list(torch.utils.data.DataLoader(valid, batch_size=4, drop_last=True)) == []
    dl = data.DataLoader(valid, batch_size=4)
    assert len(dl) == 1
    batches = [next(data.cycle(dl)) for _ in range(3)]
    assert all(b[0].shape == (2, 4, 4, 3) for b in batches)


def test_cycle_raises_on_an_empty_loader():
    with pytest.raises(ValueError, match='empty'):
        next(data.cycle(data.DataLoader([], batch_size=2)))
    with pytest.raises(ValueError, match='empty'):
        next(data.cycle([]))
    it = data.cycle([1, 2])
    assert [next(it) for _ in range(5)] == [1, 2, 1, 2, 1]


def test_dropped_batches_are_skipped_and_workers_stay_on_the_host():
    """A collator that drops a batch (returns None) costs that batch only; a
    worker process (spawned) builds batches of CPU tensors."""
    items = list(range(8))

    def collate(batch):
        return None if 0 in batch else torch.tensor(batch)

    dl = data.DataLoader(items, batch_size=2, shuffle=False, collate_fn=collate)
    assert [b.tolist() for b in dl] == [[2, 3], [4, 5], [6, 7]]
    dl = data.DataLoader(items, batch_size=4, shuffle=False, num_workers=1,
                         multiprocessing_context='spawn')   # this process has JAX's threads
    batches = list(dl)
    assert [b.tolist() for b in batches] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert all(b.device.type == 'cpu' for b in batches)


def _rows(n=4, seed=2):
    r = rng(seed)
    words = ['a red fox', 'two blue birds on a wire', 'sky', 'the quiet sea at night']
    rows = [dict(image=Image.fromarray((r.rand(18 + i, 14 + 2 * i, 3) * 255).astype(np.uint8)),
                 caption=words[i % len(words)]) for i in range(n)]
    rows.append(dict(image=b'broken bytes', caption='dropped'))
    return rows


def test_collator_matches_jax_with_a_tiny_t5(monkeypatch):
    inject_t5(monkeypatch, tiny_t5(16), jax_side=True)
    kw = dict(image_size=12, image_label='image', text_label='caption', name=TINY_T5)
    rows = _rows()
    batch = data.Collator(**kw)(rows)
    ref = jdata.Collator(**kw)(rows)
    assert set(batch) == {'images', 'text_embeds', 'text_masks'}
    assert batch['images'].shape == (4, 12, 12, 3)   # the broken row is dropped
    np.testing.assert_array_equal(batch['images'].numpy(), ref['images'])
    np.testing.assert_array_equal(batch['text_masks'].numpy(), ref['text_masks'])
    assert batch['text_embeds'].shape == ref['text_embeds'].shape
    assert max_abs(batch['text_embeds'], ref['text_embeds']) <= 1e-5
    assert float(batch['text_embeds'].abs().max()) > 0.1
    # a batch with no row left is dropped
    assert data.Collator(**kw)([dict(image=None, caption='x')]) is None

    dl = data.DataLoader(rows, batch_size=2, shuffle=False, collate_fn=data.Collator(**kw))
    assert [b['images'].shape[0] for b in dl] == [2, 2]


def test_t5_cache_is_never_moved(monkeypatch):
    """The imagen's `encode_text` and a collator share the cached T5 where it
    is: nothing calls its `.to`, and each gets its encodings on its device."""
    model = StandInEncoder(16)
    inject_t5(monkeypatch, model)
    moves = []
    monkeypatch.setattr(model, 'to', lambda *a, **kw: moves.append((a, kw)) or model)
    imagen = it.Imagen((it.Unet(dim=8, dim_mults=(1,), text_embed_dim=16, layer_attns=False,
                                layer_cross_attns=False, device='cpu'),),
                       image_sizes=(8,), timesteps=2, text_encoder_name=TINY_T5, device='cpu')
    where = t5.model_device(model)
    texts = ['a red fox', 'sky']
    emb = imagen.encode_text(texts)
    batch = data.Collator(image_size=8, image_label='image', text_label='caption',
                          name=TINY_T5)(_rows(2))
    assert moves == [] and t5.model_device(model) == where
    assert emb.device == imagen.device and batch['text_embeds'].device == torch.device('cpu')
    assert torch.equal(t5.t5_encode_text(texts, name=TINY_T5, device='cpu'), emb)


def test_prefetch_and_images_dataloader(folder):
    dl = data.get_images_dataloader(str(folder), batch_size=4, image_size=8, shuffle=False,
                                    random_flip=False)
    batches = list(dl)
    assert [b.shape for b in batches] == [(4, 8, 8, 3)]   # 6 images, the partial batch dropped
    ds = data.Dataset(str(folder), image_size=8, random_flip=False)
    np.testing.assert_array_equal(batches[0].numpy(), torch.stack([ds[i] for i in range(4)]))
    endless = data.get_images_dataloader(str(folder), batch_size=4, image_size=8,
                                         cycle_dl=True, prefetch=1)
    assert all(next(endless).shape == (4, 8, 8, 3) for _ in range(3))

    def failing():
        yield 1
        raise OSError('disk gone')

    with pytest.raises(OSError, match='disk gone'):
        list(data.PrefetchLoader(failing()))


def test_video_export_matches_jax(tmp_path):
    """gif and npy files of a clip (a tensor for the port, an array for JAX)
    hold the same bytes; mp4 is written, or refused, by both alike."""
    from imagen_tpu.utils import video_io as jvideo_io
    from imagen_tpu_torch.utils import video_io

    clip = rng(4).rand(4, 8, 10, 3).astype(np.float32)
    for ext in ('gif', 'npy'):
        mine = video_io.save_video(torch.from_numpy(clip), tmp_path / f'port.{ext}', fps=4)
        ref = jvideo_io.save_video(clip, tmp_path / f'jax.{ext}', fps=4)
        assert open(mine, 'rb').read() == open(ref, 'rb').read(), ext
    frames = video_io.video_tensor_to_pil_frames(torch.from_numpy(clip))
    assert [np.asarray(f).tolist() for f in frames] == \
        [np.asarray(f).tolist() for f in jvideo_io.video_tensor_to_pil_frames(clip)]
    paths = video_io.save_videos(torch.from_numpy(np.stack([clip, clip])),
                                 str(tmp_path / 'v_{}.gif'))
    assert [p.rsplit('/', 1)[-1] for p in paths] == ['v_0.gif', 'v_1.gif']
    outcomes = []
    for save, name in ((video_io.save_video, 'port.mp4'), (jvideo_io.save_video, 'jax.mp4')):
        try:
            outcomes.append(bool(save(clip, tmp_path / name, fps=4)))
        except RuntimeError:
            outcomes.append('refused')
    assert outcomes[0] == outcomes[1]
    with pytest.raises(ValueError):
        video_io.save_video(clip, tmp_path / 'clip.xyz')
