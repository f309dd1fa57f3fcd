"""The port's spans and route counters (`imagen_tpu_torch.utils.profiling`).

- the span tree of a served request: `serve.generate` > `sample` >
  `sample.step` > `unet.forward`, parents, one request id per root, self
  times; each thread's spans nested apart; the EDM sampler's steps;
- with nothing recording: one shared no-op span, no `record_function`
  entered, nothing allocated, no counter kept;
- under `trace()`: every program span is in the saved Chrome trace, and its
  `ts` x 1000 + `baseTimeNanoseconds` is within 1 ms of the recording's
  wall-clock stamp of it;
- the `conv3x3` counter by shape and route, with its work, on two convs (one
  the gate admits, W 64 and cin 128, one it refuses), and once a call in a
  U-Net forward;
- the `attention` counter once a call on the flash, plain-masked, direct
  and `CrossAttention` paths;
- the `threshold` counter on its CPU route (`kthvalue`) at a direct call,
  by shape, and once a step of a sampled cascade (the card's route,
  `kernel`, is held in `test_torch_cuda.py`);
- one traced run of the benchmark harness at its tiny size, in its own
  process (the harness refuses a process that has JAX loaded), whose result
  holds the four metrics that read these spans and counters.
"""
import json
import os
import subprocess
import sys
import threading
import tracemalloc
from pathlib import Path

import pytest
import torch

import imagen_tpu_torch as it
from imagen_tpu_torch.models.blocks import CrossAttention, SameConv3x3
from imagen_tpu_torch.ops import attention
from imagen_tpu_torch.utils import profiling
from imagen_tpu_torch.utils.profiling import count, recording, span, trace

REPO = Path(__file__).resolve().parents[1]
TINY = dict(dim=8, dim_mults=(1, 2), num_resnet_blocks=1, layer_attns=(False, True),
            layer_cross_attns=(False, True), attn_heads=2, attn_dim_head=4,
            text_embed_dim=16, cond_dim=8, max_text_len=8, attn_pool_num_latents=2,
            learned_sinu_pos_emb_dim=4, device='cpu')
STEPS = (3, 2)


@pytest.fixture(autouse=True)
def no_recording():
    """Every test starts and ends with nothing recording."""
    if profiling.active_recording() is not None:
        profiling.stop_recording()
    yield
    assert profiling.active_recording() is None


def _cascade(edm=False):
    torch.manual_seed(0)
    unets = (it.Unet(**TINY), it.Unet(**TINY, lowres_cond=True))
    if edm:
        return it.ElucidatedImagen(unets, image_sizes=(8, 16), text_embed_dim=16,
                                   num_sample_steps=STEPS, device='cpu').eval()
    return it.Imagen(unets, image_sizes=(8, 16), text_embed_dim=16, timesteps=STEPS,
                     device='cpu').eval()


def _embeds(b=2):
    return torch.randn(b, 8, 16, generator=torch.Generator().manual_seed(1))


def _children(rec):
    out = {}
    for s in rec.spans:
        out.setdefault(s.parent, []).append(s)
    return out


def test_span_tree_of_a_served_request():
    server = it.ImagenServer(_cascade(), batch_size=2, text_len=8, warmup=False)
    with recording() as rec:
        server.generate(text_embeds=_embeds(), generator=torch.Generator().manual_seed(2))
        server.generate(text_embeds=_embeds(), generator=torch.Generator().manual_seed(3))
    roots = [s for s in rec.spans if s.parent is None]
    assert [r.name for r in roots] == ['serve.generate'] * 2
    assert not any(s.profiled for s in rec.spans)
    kids = _children(rec)
    for root in roots:
        spans = [s for s in rec.spans if s.request == root.id]
        assert {s.name for s in spans} == {'serve.generate', 'sample', 'sample.step',
                                           'unet.forward'}
        (sample,) = kids[root.id]
        assert sample.name == 'sample'
        steps = kids[sample.id]
        assert [s.name for s in steps] == ['sample.step'] * sum(STEPS)
        for step in steps:
            (forward,) = kids[step.id]
            assert forward.name == 'unet.forward' and forward.id not in kids
            assert step.start_ns <= forward.start_ns <= forward.end_ns <= step.end_ns
    assert len(rec.requests()) == 2 and rec.requests(profiled=True) == {}
    own = rec.self_ns()
    for s in rec.spans:
        assert own[s.id] == s.ns - sum(c.ns for c in kids.get(s.id, ()))
        assert own[s.id] >= 0


def test_each_thread_nests_its_own_spans():
    def work():
        for _ in range(100):
            with span('serve.generate'):
                with span('sample'):
                    pass

    with recording() as rec:
        threads = [threading.Thread(target=work) for _ in range(4)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=60)
    assert not any(thread.is_alive() for thread in threads)
    roots = {s.id for s in rec.spans if s.parent is None}
    assert len(roots) == 400
    assert all(s.name == 'serve.generate' for s in rec.spans if s.id in roots)
    assert all(s.parent in roots and s.request == s.parent
               for s in rec.spans if s.name == 'sample')


def test_edm_steps_hold_their_euler_and_heun_forwards():
    imagen = _cascade(edm=True)
    with recording() as rec:
        imagen.sample(text_embeds=_embeds(), cond_scale=3., use_tqdm=False,
                      generator=torch.Generator().manual_seed(4))
    kids = _children(rec)
    (root,) = [s for s in rec.spans if s.parent is None]
    assert root.name == 'sample'
    steps = kids[root.id]
    assert [s.name for s in steps] == ['sample.step'] * sum(STEPS)
    # two forwards a step, one at the last step of each stage (sigma_next 0)
    forwards = [len(kids[s.id]) for s in sorted(steps, key=lambda s: s.start_ns)]
    assert forwards == [2, 2, 1, 2, 1]


def test_nothing_recorded_allocated_or_annotated_when_off(monkeypatch):
    entered = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, 'record_function',
                        lambda name, *a: entered.append(name) or real(name, *a))
    assert span('a') is span('b')
    unet = it.Unet(**TINY).eval()
    with torch.no_grad():
        unet(torch.randn(1, 8, 8, 3), torch.zeros(1), text_embeds=_embeds(1))
    assert entered == []

    def loop():
        for _ in range(2000):
            with span('unet.forward'):
                pass
            count('conv3x3', 'cudnn', (1, 8, 8, 8, 8), 1)

    loop()
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        loop()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    here = [d for d in after.compare_to(before, 'filename')
            if d.traceback[0].filename == profiling.__file__]
    assert sum(d.size_diff for d in here) == 0 and sum(d.count_diff for d in here) == 0
    with recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}


def test_program_spans_stand_on_the_traces_clock(tmp_path):
    imagen = _cascade()
    with recording() as rec, trace(tmp_path):
        imagen.sample(text_embeds=_embeds(), cond_scale=3., use_tqdm=False,
                      generator=torch.Generator().manual_seed(5))
    assert rec.spans and all(s.profiled for s in rec.spans)
    (path,) = tmp_path.glob('*.pt.trace.json')
    data = json.loads(path.read_text())
    base = data['baseTimeNanoseconds']
    names = {s.name for s in rec.spans}
    events = {}
    for e in data['traceEvents']:
        if e.get('ph') == 'X' and e.get('name') in names:
            events.setdefault(e['name'], []).append(e)
    for name in names:
        spans = sorted((s for s in rec.spans if s.name == name), key=lambda s: s.start_ns)
        found = sorted(events.get(name, []), key=lambda e: e['ts'])
        assert len(found) == len(spans), name
        for s, e in zip(spans, found):
            assert abs(e['ts'] * 1e3 + base - rec.wall_ns(s.start_ns)) < 1e6, name
            assert abs((e['ts'] + e['dur']) * 1e3 + base - rec.wall_ns(s.end_ns)) < 1e6, name


def test_conv3x3_counted_by_shape_and_route():
    torch.manual_seed(6)
    admitted, refused = SameConv3x3(128, 128), SameConv3x3(128, 16)
    x = torch.randn(1, 256, 64, 128)
    with recording() as rec, torch.no_grad():
        for _ in range(2):
            refused(admitted(x))
    work = 2 * 256 * 64 * 9 * 128
    assert rec.counters == {
        ('conv3x3', 'kernel', (1, 256, 64, 128, 128)): [2, 2 * work * 128],
        ('conv3x3', 'cudnn', (1, 256, 64, 128, 16)): [2, 2 * work * 16],
    }
    assert rec.share('conv3x3', 'kernel') == pytest.approx(100 * 128 / 144)

    unet = it.Unet(**TINY).eval()
    convs = sum(isinstance(m, SameConv3x3) for m in unet.modules())
    with recording() as rec, torch.no_grad():
        unet(torch.randn(2, 8, 8, 3), torch.zeros(2), text_embeds=_embeds())
    assert rec.routes('conv3x3').keys() == {'cudnn'}
    assert rec.routes('conv3x3')['cudnn'][0] == convs > 0


def test_attention_routes_counted_once_each():
    g = torch.Generator().manual_seed(7)
    b, n, heads, d, j = 1, 1024, 2, 16, 5
    q = torch.randn(b, n, heads * d, generator=g)
    k, v = torch.randn(2, b, j, d, generator=g)
    mask = torch.ones(b, j - 1, dtype=torch.bool)
    scale = dict(q_scale=torch.ones(d), k_scale=torch.ones(d))
    with recording() as rec:
        attention.multiquery_attention_packed(q, k, v, heads, scale=8., **scale)
        attention.multiquery_attention_packed(q, k, v, heads, scale=8., mask=mask,
                                              null_tokens=1, **scale)
        attention.multiquery_attention(q[:, :64].reshape(b, 64, heads, d).transpose(1, 2),
                                       k, v, scale=8.)
    work = 4 * b * heads * j * d
    assert rec.counters == {
        ('attention', 'flash', (b, heads, n, j, d, False, False)): [1, work * n],
        ('attention', 'plain', (b, heads, n, j, d, True, False)): [1, work * n],
        ('attention', 'plain', (b, heads, 64, j, d, False, False)): [1, work * 64],
    }
    assert rec.share('attention', 'flash') == pytest.approx(100 * 1024 / 2112)

    cross = CrossAttention(32, context_dim=12, dim_head=d, heads=heads).eval()
    with recording() as rec, torch.no_grad():
        cross(torch.randn(b, 20, 32, generator=g), torch.randn(b, 6, 12, generator=g),
              mask=torch.ones(b, 6, dtype=torch.bool))
    # the null key is prepended: 7 keys
    assert rec.counters == {
        ('attention', 'plain', (b, heads, 20, 7, d, True, False)): [1, 4 * b * heads * 20 * 7 * d]}


def test_threshold_counted_by_route():
    imagen = _cascade()
    x = torch.randn(2, 8, 8, 3, generator=torch.Generator().manual_seed(8))
    with recording() as rec:
        imagen.threshold_x_start(x)
        imagen.threshold_x_start(x, dynamic_threshold=False)
    assert rec.counters == {('threshold', 'kthvalue', (2, 192)): [1, 384]}

    with recording() as rec:
        imagen.sample(text_embeds=_embeds(), cond_scale=3., use_tqdm=False,
                      generator=torch.Generator().manual_seed(4))
    # one call a step: 2 images of 8 x 8 x 3 at the first stage, of 16 x 16 x 3 at the second
    kept = {key: v for key, v in rec.counters.items() if key[0] == 'threshold'}
    assert kept == {('threshold', 'kthvalue', (2, 192)): [STEPS[0], STEPS[0] * 384],
                    ('threshold', 'kthvalue', (2, 768)): [STEPS[1], STEPS[1] * 1536]}


HARNESS = '''
import json, sys, torch
from port_bench import run
from port_bench.tests import tiny
root = tiny.make_root(sys.argv[1])
sys.exit(run.run(['--workload', 'tiny-serve', '--seed', str(2 ** 31 + 13), '--seconds', '0.2',
                  '--trace', '1'], root=root, device=torch.device('cpu')))
'''


def test_a_traced_tiny_harness_run_reads_the_program(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    done = subprocess.run([sys.executable, '-c', HARNESS, str(tmp_path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert done.returncode == 0, done.stderr[-4000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result['correct'] is True
    metrics = {k: v['value'] for k, v in result['metrics'].items()}
    for name in ('conv3x3.kernel_share', 'attn.flash_share'):
        assert 0. <= metrics[name] <= 100., name
    for name in ('unet.host_ms_per_fwd', 'sample.step_self_ms'):
        assert 0. < metrics[name] < 10_000., name
    assert result['metrics']['unet.host_ms_per_fwd']['unit'] == 'ms'
