"""The port's `Unet3D` against the benchmark's plain float32 reference
(`port_bench/reference/unet3d.py`), on the CPU, with the benchmark's seeded
weights (`port_bench.weights`), at dim 32, mults (1, 2), 4 frames of 16 px
and 2 heads:

- the forward, float32, to 1e-4;
- one sampler step of a 4-frame clip taken again by `reference.video.follow`
  from the program's state before it, with the same draws;
- the `video.temporal` spans (one per temporal PEG and attention pair and
  per pseudo-3D conv's temporal conv), each under `unet.forward`, and the
  `temporal_attention` counter at the per-pixel dispatch;
- `PseudoConv3d`'s spatial conv, at a shape `SameConv3x3`'s gate admits,
  takes the conv kernel's route and gives the output of the plain `Conv2d`
  it replaced, bit for bit.

Nothing here imports JAX.
"""
import pytest
import torch

import imagen_tpu_torch as it
from imagen_tpu_torch.models.blocks import Conv2d, SameConv3x3
from imagen_tpu_torch.models.video_blocks import CausalTemporalConv, PseudoConv3d, TemporalPeg
from imagen_tpu_torch.utils.profiling import recording
from port_bench import weights
from port_bench.reference import numerics, video
from port_bench.reference.unet3d import Unet3D as ReferenceUnet3D

SPEC = dict(dim=32, dim_mults=(1, 2), num_resnet_blocks=1, layer_attns=(False, True),
            layer_cross_attns=(False, True), attn_heads=2, attn_dim_head=16, ff_mult=2.,
            attn_pool_num_latents=4, text_embed_dim=12, max_text_len=6)
B, FRAMES, SIZE = 2, 4, 16


@pytest.fixture(scope='module')
def pair():
    """The port's and the reference's `Unet3D`, holding the same seeded weights."""
    numerics.no_tf32()
    with torch.device('meta'):
        ref = ReferenceUnet3D(**SPEC, lowres_cond=False)
    specs = [(name, tuple(t.shape)) for name, t in ref.state_dict().items()]
    state = weights.make(specs, weights.derive(7, 'weights', 0), torch.device('cpu'))
    ref.load_state_dict(state, strict=True, assign=True)
    port = it.Unet3D(**SPEC, device='cpu')
    port.load_state_dict(state, strict=True)
    return port.eval(), ref.eval()


def _inputs():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(B, FRAMES, SIZE, SIZE, 3, generator=gen)
    embeds = torch.randn(B, 6, 12, generator=gen) * 0.2
    mask = torch.ones(B, 6, dtype=torch.bool)
    mask[0, 4:] = False
    return x, torch.randn(B, generator=gen), embeds * mask[..., None], mask


@torch.no_grad()
def test_forward_matches_the_reference(pair):
    port, ref = pair
    x, t, embeds, mask = _inputs()
    drop = torch.tensor([False, True])
    out = port(x, t, text_embeds=embeds, text_mask=mask, force_text_drop_mask=drop)
    want = ref(x, t, text_embeds=embeds, text_mask=mask, drop_text=drop)
    assert out.shape == (B, FRAMES, SIZE, SIZE, 3)
    assert (out - want).abs().max().item() <= 1e-4


def test_a_sampler_step_is_followed(pair):
    port, ref = pair
    _, _, embeds, mask = _inputs()
    imagen = it.Imagen((port,), image_sizes=(SIZE,), timesteps=(3,), text_embed_dim=12,
                       device='cpu').eval()
    trail, inner = [], imagen.p_sample

    def p_sample(unet, x, t, **kwargs):
        out = inner(unet, x, t, **kwargs)
        if not trail:
            trail.append(x.clone())
        trail.append(out[0].clone())
        return out

    imagen.p_sample = p_sample
    out = imagen.sample(text_embeds=embeds, text_masks=mask, video_frames=FRAMES, cond_scale=3.,
                        generator=torch.Generator().manual_seed(5), use_tqdm=False)
    start, errors, answer = video.follow(
        ref, [trail], frames_per_clip=FRAMES, image_size=SIZE, steps=3, text_embeds=embeds,
        text_masks=mask, cond_scale=3., generator=torch.Generator().manual_seed(5))
    assert start == 0.
    assert len(errors) == 3
    assert max(err.abs().max().item() for _, _, err in errors) <= 1e-4
    assert torch.equal(answer, out.reshape(-1, SIZE, SIZE, 3))


@torch.no_grad()
def test_temporal_spans_and_counter(pair):
    port, _ = pair
    x, t, embeds, mask = _inputs()
    with recording() as rec:
        port(x, t, text_embeds=embeds, text_mask=mask)
    by_id = {s.id: s for s in rec.spans}
    temporal = [s for s in rec.spans if s.name == 'video.temporal']
    pairs = sum(isinstance(m, TemporalPeg) for m in port.modules())
    convs = sum(isinstance(m, CausalTemporalConv) for m in port.modules())
    assert (pairs, convs) == (6, 22)
    assert len(temporal) == pairs + convs
    for s in temporal:
        while by_id[s.parent].name != 'unet.forward':
            s = by_id[s.parent]
    pixels, heads, d = B * SIZE * SIZE, 2, 16
    assert rec.routes('temporal_attention') == {'kernel': [pairs, sum(
        4 * B * (SIZE >> level) ** 2 * heads * FRAMES * (FRAMES + 1) * d
        for level in (0, 0, 0, 1, 1, 1))]}
    assert rec.share('temporal_attention', 'kernel') == 100.
    assert ('temporal_attention', 'kernel', (pixels, FRAMES, heads, FRAMES + 1, d)) \
        in rec.counters
    # the flat self-attention over (f h w) tokens and their null key, with the
    # conditioning tokens in the transformer blocks: the middle's and the level-2 blocks'
    flat = {key[2][3]: calls for key, (calls, _) in rec.counters.items()
            if key[0] == 'attention' and key[2][3] > FRAMES * 64}
    assert flat == {FRAMES * 64 + 1: 1, FRAMES * 64 + 11: 2}


@torch.no_grad()
def test_spatial_conv_route_keeps_the_output(monkeypatch):
    # 128 channels on 128 px frames: a shape `SameConv3x3`'s gate sends to
    # the conv kernel's route, where the plain `Conv2d` it replaced took F.conv2d
    conv = PseudoConv3d(128, 128)
    gen = torch.Generator().manual_seed(11)
    for p in conv.parameters():
        p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    x = torch.randn(1, 2, 128, 128, 128, generator=gen)
    with recording() as rec:
        out = conv(x)
    assert rec.routes('conv3x3') == {'kernel': [1, 18 * 2 * 128 ** 4]}
    monkeypatch.setattr(SameConv3x3, 'forward', Conv2d.forward)
    assert torch.equal(out, conv(x))
