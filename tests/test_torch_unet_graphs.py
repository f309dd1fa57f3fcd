"""The CUDA graph route of the U-Net's inference forward (`models/unet_graphs.py`).

A stand-in takes the place of `torch.cuda.CUDAGraph` (`unet_graphs.Graph`):
it "captures" by running the forward once and "replays" by running it again
into the same output tensor, recording nothing, as a replay issues nothing
from Python. `unet_graphs.DEVICE_TYPE` is set to the CPU so the route's logic
runs here; on the card the same tests' counterparts run the real graphs
(`test_torch_cuda.py`). Imports no JAX.
"""
import contextlib
import copy
import pickle

import pytest
import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

import imagen_tpu_torch as it
from imagen_tpu_torch.models import unet_graphs
from imagen_tpu_torch.ops import _build
from imagen_tpu_torch.utils import profiling
from imagen_tpu_torch.utils.profiling import count, recording, taping

TINY = dict(dim=8, dim_mults=(1, 2), num_resnet_blocks=1, layer_attns=(False, True),
            layer_cross_attns=(False, True), attn_heads=2, attn_dim_head=4,
            text_embed_dim=16, cond_dim=8, max_text_len=8, attn_pool_num_latents=2,
            learned_sinu_pos_emb_dim=4, device='cpu')
VIDEO = dict(dim=8, dim_mults=(1, 2), text_embed_dim=16, cond_dim=8, attn_dim_head=4,
             attn_heads=2, attn_pool_num_latents=2, max_text_len=8, layer_attns=False,
             layer_cross_attns=(False, True), device='cpu')


class StandInGraph:
    """What `unet_graphs.CudaGraph` does, on the CPU."""
    made = []

    def __init__(self, fn, device, pool=None):
        self.fn, self.device = fn, device
        self.output = fn()
        self.pool = pool if pool is not None else object()
        self.replays = 0
        StandInGraph.made.append(self)

    def replay(self):
        with taping():
            self.output.copy_(self.fn())
        self.replays += 1


class FailingGraph:
    def __init__(self, fn, device, pool=None):
        raise RuntimeError('operation not permitted when stream is capturing')


@pytest.fixture(autouse=True)
def no_recording():
    if profiling.active_recording() is not None:
        profiling.stop_recording()
    yield
    assert profiling.active_recording() is None


@pytest.fixture
def graphed(monkeypatch):
    """The route on the CPU with the stand-in; no gradient."""
    monkeypatch.setattr(unet_graphs, 'DEVICE_TYPE', 'cpu')
    monkeypatch.setattr(unet_graphs, 'Graph', StandInGraph)
    StandInGraph.made = []
    with torch.no_grad():
        yield


def _unet(video=False, **kwargs):
    torch.manual_seed(0)
    unet = (it.Unet3D(**VIDEO, **kwargs) if video else it.Unet(**TINY, **kwargs)).eval()
    with torch.no_grad():
        unet.final_conv.weight.normal_(0., 0.1)   # zero at init: let every weight reach out
    return unet


def _inputs(b=2, seed=1, video=False, lowres=False):
    g = torch.Generator().manual_seed(seed)
    shape = (b, 2, 8, 8, 3) if video else (b, 8, 8, 3)
    kw = dict(time=torch.rand(b, generator=g), text_embeds=torch.randn(b, 8, 16, generator=g),
              text_mask=torch.rand(b, 8, generator=g) < 0.7,
              force_text_drop_mask=torch.arange(b) >= b // 2)
    if lowres:
        kw.update(lowres_cond_img=torch.randn(shape, generator=g),
                  lowres_noise_times=torch.rand(b, generator=g))
    return torch.randn(shape, generator=g), kw


def _eager(unet, x, kw):
    """The forward as it runs off the route."""
    inputs = dict(lowres_cond_img=None, lowres_noise_times=None, text_embeds=None,
                  text_mask=None, cond_images=None, self_cond=None, cond_drop_prob=0.,
                  force_text_drop_mask=None)
    if isinstance(unet, it.Unet3D):
        inputs.update(cond_video_frames=None, post_cond_video_frames=None, ignore_time=False)
    with torch.no_grad():
        return unet._forward(x, **inputs | kw)


def _routes(rec):
    return {route: calls for route, (calls, _) in rec.routes('unet_graph').items()}


def test_eager_on_the_cpu():
    unet = _unet()
    x, kw = _inputs()
    with recording() as rec, torch.no_grad():
        for _ in range(3):
            unet(x, **kw)
    assert rec.routes('unet_graph') == {'eager': [3, 6]}
    assert not unet._forward_graphs.entries


EAGER_CASES = {   # each sets its case up inside an ExitStack
    'grad': lambda unet, kw, stack: stack.enter_context(torch.enable_grad()),
    'train': lambda unet, kw, stack: unet.train(),
    'profiler': lambda unet, kw, stack: stack.enter_context(torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])),
    'flop_counter': lambda unet, kw, stack: stack.enter_context(FlopCounterMode(display=False)),
    'forward_hook': lambda unet, kw, stack: unet.final_conv.register_forward_hook(
        lambda *args: None),
    'forward_pre_hook': lambda unet, kw, stack: unet.mid_block1.register_forward_pre_hook(
        lambda *args: None),
    'global_hook': lambda unet, kw, stack: stack.callback(
        nn.modules.module.register_module_forward_hook(lambda *args: None).remove),
    'generator_drawn': lambda unet, kw, stack: kw.update(force_text_drop_mask=None,
                                                         cond_drop_prob=0.5),
    'unhashable': lambda unet, kw, stack: kw.update(cond_drop_prob=[0.]),
}


@pytest.mark.parametrize('case', list(EAGER_CASES))
def test_eager_route(graphed, case):
    unet = _unet()
    x, kw = _inputs()
    with contextlib.ExitStack() as stack:
        EAGER_CASES[case](unet, kw, stack)
        with recording() as rec:
            outs = [unet(x, **kw, generator=torch.Generator().manual_seed(3))
                    for _ in range(3)]
    assert _routes(rec) == {'eager': 3}
    assert StandInGraph.made == []
    if case not in ('train', 'generator_drawn'):   # dropout and the text drop draw
        for out in outs[1:]:
            assert torch.equal(out, outs[0])


def test_a_hook_on_the_unet_itself_keeps_the_route(graphed):
    unet = _unet()
    seen = []
    unet.register_forward_hook(lambda mod, args, out: seen.append(out))
    x, kw = _inputs()
    with recording() as rec:
        for _ in range(3):
            unet(x, **kw)
    assert _routes(rec) == {'eager': 1, 'capture': 1, 'replay': 1}
    assert len(seen) == 3


@pytest.mark.parametrize('video', [False, True], ids=['unet', 'unet3d'])
@pytest.mark.parametrize('lowres', [False, True], ids=['base', 'lowres'])
def test_first_eager_then_capture_then_replays(graphed, video, lowres):
    unet = _unet(video, lowres_cond=lowres)
    x, kw = _inputs(video=video, lowres=lowres)
    with recording() as rec:
        outs = [unet(x, **kw) for _ in range(4)]
    assert _routes(rec) == {'eager': 1, 'capture': 1, 'replay': 2}
    key = (type(unet).__name__, tuple(x.shape))
    assert rec.counters[('unet_graph', 'replay', key)] == [2, 4]
    (graph,) = StandInGraph.made
    assert graph.replays == 3   # the capturing call replays too
    want = _eager(unet, x, kw)
    for out in outs:
        assert torch.equal(out, want)
    # new values at the same signature go through the static buffers
    x2, kw2 = _inputs(seed=5, video=video, lowres=lowres)
    assert torch.equal(unet(x2, **kw2), _eager(unet, x2, kw2))
    assert len(StandInGraph.made) == 1


def test_texts_of_any_length_share_one_graph(graphed):
    unet = _unet()
    outs, wants = [], []
    with recording() as rec:
        for n in (3, 8, 5, 12):
            x, kw = _inputs(seed=n)
            kw.update(text_embeds=kw['text_embeds'].repeat(1, 2, 1)[:, :n],
                      text_mask=kw['text_mask'].repeat(1, 2)[:, :n])
            outs.append(unet(x, **kw))
            wants.append(_eager(unet, x, kw))
    assert _routes(rec) == {'eager': 1, 'capture': 1, 'replay': 2}
    for out, want in zip(outs, wants):
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)


def _add(unet):
    unet.final_conv.weight.add_(0.5)


def _replace(unet):
    unet.final_conv.weight = nn.Parameter(unet.final_conv.weight * 2.)


def _to(unet):
    unet.to('cpu')


def _load(unet):
    state = {k: v * 1.5 for k, v in unet.state_dict().items()}
    unet.load_state_dict(state)


@pytest.mark.parametrize('change', [_add, _replace, _to, _load],
                         ids=['add_', 'replaced', 'to', 'load_state_dict'])
def test_a_changed_parameter_forces_a_new_capture(graphed, change):
    unet = _unet()
    x, kw = _inputs()
    for _ in range(3):
        before = unet(x, **kw)
    change(unet)
    with recording() as rec:
        outs = [unet(x, **kw) for _ in range(3)]
    assert _routes(rec) == {'eager': 1, 'capture': 1, 'replay': 1}
    assert len(StandInGraph.made) == 2
    want = _eager(unet, x, kw)
    if change is not _to:
        assert not torch.equal(want, before)
    for out in outs:
        assert torch.equal(out, want)


def test_the_least_recently_used_graph_is_dropped(graphed):
    unet = _unet()
    inputs = {b: _inputs(b) for b in range(1, unet_graphs.CAP + 2)}
    with recording() as rec:
        for b in inputs:
            for _ in range(2):
                unet(inputs[b][0], **inputs[b][1])
    assert _routes(rec) == {'eager': 5, 'capture': 5}
    graphs = unet._forward_graphs
    assert len(graphs.entries) == unet_graphs.CAP
    with recording() as rec:
        unet(inputs[5][0], **inputs[5][1])    # kept
        unet(inputs[2][0], **inputs[2][1])    # kept, now the most recent
        unet(inputs[1][0], **inputs[1][1])    # dropped: called once again, eagerly
    assert [(route, key[1][0]) for (name, route, key) in rec.counters
            if name == 'unet_graph'] == [
        ('replay', 5), ('replay', 2), ('eager', 1)]
    assert len(graphs.entries) == unet_graphs.CAP
    with recording() as rec:
        unet(inputs[3][0], **inputs[3][1])    # pushed out by batch 1
    assert _routes(rec) == {'eager': 1}


def test_the_output_does_not_alias_the_graph(graphed):
    unet = _unet()
    x, kw = _inputs()
    x2, kw2 = _inputs(seed=9)
    unet(x, **kw)
    unet(x, **kw)
    first = unet(x, **kw)
    kept = first.clone()
    (graph,) = StandInGraph.made
    assert first.data_ptr() != graph.output.data_ptr()
    second = unet(x2, **kw2)
    assert torch.equal(first, kept) and not torch.equal(second, kept)


def test_counters_and_launches_of_a_replay_match_the_eager_forward(graphed, monkeypatch):
    unet = _unet()
    x, kw = _inputs()
    # a stand-in launch at each forward, as the kernels' wrappers count theirs
    inner = unet.final_conv.forward

    def final_conv(t):
        _build.LAUNCHES['stand_in_kernel'] += 1
        return inner(t)

    monkeypatch.setattr(unet.final_conv, 'forward', final_conv)
    before = _build.LAUNCHES['stand_in_kernel']
    replayed = _build.REPLAYED['stand_in_kernel']
    with recording() as rec:
        for _ in range(4):
            unet(x, **kw)
    assert _routes(rec) == {'eager': 1, 'capture': 1, 'replay': 2}
    # the eager call launched; the capture's call and the replays ran the graph
    assert rec.launches['stand_in_kernel'] == 1 and rec.replayed['stand_in_kernel'] == 3
    assert _build.LAUNCHES['stand_in_kernel'] == before + 1
    assert _build.REPLAYED['stand_in_kernel'] == replayed + 3
    monkeypatch.setattr(unet_graphs, 'DEVICE_TYPE', 'cuda')
    with recording() as eager:
        for _ in range(4):
            unet(x, **kw)
    assert _routes(eager) == {'eager': 4}

    def others(r):
        return {k: v for k, v in r.counters.items() if k[0] != 'unet_graph'}

    assert others(rec) == others(eager)
    assert {'conv3x3', 'attention'} <= {k[0] for k in others(rec)}


def test_taping_keeps_counts_and_launches_for_each_replay():
    with recording() as rec:
        before, replayed = _build.LAUNCHES['taped'], _build.REPLAYED['taped']
        with taping() as tape:
            count('taped', 'r', (1,), 5)
            _build.LAUNCHES['taped'] += 2
        assert rec.counters == {} and _build.LAUNCHES['taped'] == before
        tape.replay()
        tape.replay()
    assert rec.counters == {('taped', 'r', (1,)): [2, 10]}
    # replays count apart: LAUNCHES holds only what a wrapper launched
    assert rec.launches['taped'] == 0 and rec.replayed['taped'] == 4
    assert _build.LAUNCHES['taped'] == before
    assert _build.REPLAYED['taped'] == replayed + 4
    _build.reset_launches()
    assert not _build.LAUNCHES and not _build.REPLAYED


def test_a_failed_capture_stays_eager(graphed, monkeypatch):
    monkeypatch.setattr(unet_graphs, 'Graph', FailingGraph)
    unet = _unet()
    x, kw = _inputs()
    with recording() as rec:
        unet(x, **kw)
        with pytest.warns(UserWarning, match='could not be captured'):
            out = unet(x, **kw)
        unet(x, **kw)
    assert _routes(rec) == {'eager': 3}
    assert torch.equal(out, _eager(unet, x, kw))


def test_a_copy_of_a_unet_holds_no_graphs(graphed):
    unet = _unet()
    x, kw = _inputs()
    for _ in range(2):
        unet(x, **kw)
    assert len(unet._forward_graphs.entries) == 1
    for twin in (copy.deepcopy(unet), pickle.loads(pickle.dumps(unet))):
        assert not twin._forward_graphs.entries
        with recording() as rec:
            assert torch.equal(twin(x, **kw), unet(x, **kw))
        assert rec.counters[('unet_graph', 'eager', ('Unet', tuple(x.shape)))][0] == 1


def test_a_guided_sample_replays_each_stage(graphed):
    torch.manual_seed(0)
    unets = (_unet(), _unet(lowres_cond=True))
    imagen = it.Imagen(unets, image_sizes=(8, 16), text_embed_dim=16, timesteps=(3, 2),
                       device='cpu').eval()
    emb = torch.randn(2, 8, 16, generator=torch.Generator().manual_seed(1))

    def sample():
        return imagen.sample(text_embeds=emb, cond_scale=3.,
                             generator=torch.Generator().manual_seed(2))

    with recording() as rec:
        graphed_images = sample()
    assert {(route, key[1]) for (name, route, key) in rec.counters
            if name == 'unet_graph'} == {
        ('eager', (4, 8, 8, 3)), ('capture', (4, 8, 8, 3)), ('replay', (4, 8, 8, 3)),
        ('eager', (4, 16, 16, 3)), ('capture', (4, 16, 16, 3))}
    unets[1].final_conv.register_forward_hook(lambda *args: None)
    unets[0].final_conv.register_forward_hook(lambda *args: None)
    assert torch.equal(sample(), graphed_images)
