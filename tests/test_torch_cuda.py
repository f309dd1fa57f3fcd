"""The CUDA kernels of imagen_tpu_torch against their plain PyTorch versions.

Each kernel's bf16 output and the plain version's bf16 output are measured
against the plain version in fp32 on the same (bf16-valued) inputs; the
kernel passes if its error is at most max(2x the plain bf16 error, 1e-3).
Gradients are held the same way: through the kernels' autograd Functions
against plain autograd in fp32, each gradient to its own bound.
These tests need an NVIDIA GPU and nvcc and skip without a GPU. They import
no JAX, so on a machine without JAX run them without the repo's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""
import numpy as np
import pytest
import torch

from torch_port_bridge import max_abs, randn, rng, t

import imagen_tpu_torch as it
from imagen_tpu_torch.models import blocks
from imagen_tpu_torch.ops import _build
from imagen_tpu_torch.ops import conv2d as c2d
from imagen_tpu_torch.ops import flash_attention as fa
from imagen_tpu_torch.ops import fused_norm as fn
from imagen_tpu_torch.ops import stem_conv as stem
from imagen_tpu_torch.ops import temporal_layout as tl

BF16 = torch.bfloat16


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    # the fp32 truth in full fp32: no TF32 in matmuls or cuDNN convs
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', False)
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', False)
    return torch.device('cuda')


def _check(run, plain, bf16_inputs, fp32_inputs, name):
    before = _build.LAUNCHES[name]
    out = run(*bf16_inputs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    truth = plain(*fp32_inputs)
    err_k = max_abs(out.float(), truth)
    err_p = max_abs(plain(*bf16_inputs).float(), truth)
    assert err_k <= max(2 * err_p, 1e-3), (err_k, err_p)


# (b, rows, nk, d): ragged nk (1, 63, 65, 77, 150, 1063, 4097), rows that are
# not a multiple of the 128-row block (130, 200), d padded (40 -> 64) or at
# the ends of the kernels' range (16, 128), batch 1 and 8. The forward's last
# key tile is 64, 32 and 16 keys wide at nk 1063, 150 and 4097 (d 64) and
# 16 at nk 65 (d 128)
FLASH_CASES = [(2, 2048, 1063, 64), (2, 512, 77, 32), (2, 200, 200, 40), (1, 130, 1, 16),
               (1, 200, 65, 128), (8, 1024, 63, 64), (2, 1024, 4097, 64), (2, 256, 150, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize('b,rows,nk,d', FLASH_CASES)
@pytest.mark.parametrize('cosine', [True, False], ids=['cosine', 'plain'])
def test_flash_kernel_matches_plain(cuda, b, rows, nk, d, cosine):
    r = rng(3)
    q, k, v = (t(randn(r, b, n, d)).to(cuda).to(BF16) for n in (rows, nk, nk))
    qs, ks = (t(1. + randn(r, d, scale=0.1)).to(cuda) for _ in range(2))
    if cosine:
        def run(q, k, v):
            return fa.flash_cosine_mqa_rows(q, k, v, qs, ks, 8.)

        def plain(q, k, v):
            return fa.flash_rows_reference(q, fa.l2norm_scale(k, ks), v, 8., qs)
    else:   # pre-normalised q and k, scaled only
        q, k = (fa.l2norm_scale(x, torch.ones(d, device=cuda)) for x in (q, k))

        def run(q, k, v):
            return fa.flash_mqa_rows(q, k, v, 8.)

        def plain(q, k, v):
            return fa.flash_rows_reference(q, k, v, 8.)

    _check(run, plain, (q, k, v), (q.float(), k.float(), v.float()), fa.KERNEL)


def _conv_inputs(cuda, shape, cout, seed=4, corners=False):
    """bf16 x (nonzero only at the four image corners with `corners`), w
    scaled to unit outputs, and bias."""
    r = rng(seed)
    b, H, W, cin = shape
    x = randn(r, *shape)
    if corners:
        keep = np.zeros((H, W, 1), np.float32)
        keep[0, 0] = keep[0, -1] = keep[-1, 0] = keep[-1, -1] = 1.
        x = x * keep
    x = t(x).to(cuda).to(BF16)
    w = t(randn(r, 3, 3, cin, cout, scale=(9 * cin) ** -0.5)).to(cuda).to(BF16)
    bias = t(randn(r, cout, scale=0.1)).to(cuda).to(BF16)
    return x, w, bias


# (x shape, cout, bias, the tiling `conv_tiles` chooses: rows a tile and
# whether the grid is persistent): ragged W 100 and H 7; b 1, 2 and 3; cin
# 16, 48, 64, 128 and 2048; cout 8, 70, 128, 384 and 1024 (8 and 70 leave the
# second 64-channel block of a tile wholly or partly outside cout)
CONV_CASES = [((2, 16, 128, 128), 128, True, (2, False)),
              ((1, 7, 100, 64), 70, True, (2, False)),
              ((1, 7, 100, 16), 128, False, (2, False)),
              ((3, 12, 70, 48), 1024, False, (4, True)),
              ((1, 132, 256, 16), 8, True, (4, False)),
              ((1, 128, 64, 64), 384, True, (2, True)),
              ((2, 64, 64, 2048), 128, True, (2, False)),
              ((2, 64, 64, 1024), 1024, True, (4, True))]


@pytest.mark.cuda
@pytest.mark.parametrize('shape,cout,with_bias,tiling', CONV_CASES)
def test_conv2d_kernel_matches_plain(cuda, shape, cout, with_bias, tiling):
    tiles = c2d.conv_tiles(*shape, cout)
    assert (tiles.rows, tiles.grid < tiles.tiles) == tiling
    assert tiles.smem <= c2d.SMEM_LIMIT
    x, w, bias = _conv_inputs(cuda, shape, cout)
    if not with_bias:
        bias = None
    fp32 = (x.float(), w.float(), None if bias is None else bias.float())
    _check(c2d.conv2d_same, c2d.conv2d_same_reference, (x, w, bias), fp32, c2d.KERNEL)


@pytest.mark.cuda
@pytest.mark.parametrize('shape,cout', [((2, 9, 100, 64), 128), ((1, 8, 64, 128), 72)])
def test_conv2d_kernel_zero_halo_at_every_tap(cuda, shape, cout):
    """An input that is nonzero only at the four image corners: each corner
    reaches its 3 x 3 neighbourhood through the tap that points back at it,
    and every other output is the bias alone, exactly."""
    x, w, bias = _conv_inputs(cuda, shape, cout, seed=12, corners=True)
    _check(c2d.conv2d_same, c2d.conv2d_same_reference, (x, w, bias),
           (x.float(), w.float(), bias.float()), c2d.KERNEL)
    out = c2d.conv2d_same(x, w, bias)
    H, W = shape[1:3]
    far = torch.ones((H, W), dtype=torch.bool, device=cuda)
    for y in (0, H - 1):
        for xx in (0, W - 1):
            far[max(y - 1, 0):y + 2, max(xx - 1, 0):xx + 2] = False
    assert torch.equal(out[:, far], bias.expand_as(out[:, far]))


@pytest.mark.cuda
def test_conv2d_kernel_is_deterministic(cuda):
    x, w, bias = _conv_inputs(cuda, (2, 64, 64, 1024), 1024, seed=13)
    first = c2d.conv2d_same(x, w, bias)
    assert torch.equal(first, c2d.conv2d_same(x, w, bias))


@pytest.mark.cuda
def test_same_conv_module_runs_the_kernel_right(cuda, monkeypatch):
    """`SameConv3x3` hands the kernel a permuted bf16 view of its (O, I, 3, 3)
    weight: its output is held to fp32 as its cuDNN route (gate closed) is."""
    torch.manual_seed(14)
    conv = blocks.SameConv3x3(128, 256, dtype=BF16).to(cuda)
    x = t(randn(rng(15), 2, 128, 128, 128)).to(cuda).to(BF16)
    before = _build.LAUNCHES[c2d.KERNEL]
    with torch.no_grad():
        out = conv(x)
        assert _build.LAUNCHES[c2d.KERNEL] == before + 1
        w, bias = (v.to(BF16).float() for v in (conv.weight, conv.bias))
        truth = c2d.conv2d_same_reference(x.float(), w.permute(2, 3, 1, 0), bias)
        monkeypatch.setattr(blocks, 'conv2d_same_available', lambda *a, **k: False)
        plain = conv(x)
    assert _build.LAUNCHES[c2d.KERNEL] == before + 1
    assert max_abs(out.float(), truth) <= _bound(max_abs(plain.float(), truth))


# (rows, k, hid) and the cluster `ff_tiles` splits hid over: the paths' sites
# (BaseUnet64's 32^2 TransformerBlock at batch 8; the Perceivers at b 2, 4
# and 8 x 36 latents, k 512 in BaseUnet64, 128 in the SR unets), rows ragged
# against the 64-row tile (8, 72, 200, 300, 8200), every cluster size the
# tiler can choose (1, 2, 4, 8), every hidden slice (128, 256, 512) and every
# k it takes (128 to 512)
FF_CASES = [(8192, 512, 1024, 2), (72, 128, 512, 2), (144, 128, 512, 2), (288, 128, 512, 2),
            (72, 512, 2048, 8), (144, 512, 2048, 8), (288, 512, 2048, 8), (8, 512, 1024, 8),
            (8200, 512, 1024, 2), (300, 256, 1024, 4), (200, 384, 128, 1), (72, 256, 256, 2),
            (8448, 128, 512, 1)]


def _ff_inputs(cuda, rows, k, hid, seed=5):
    r = rng(seed)
    x = t(randn(r, rows, k)).to(cuda).to(BF16)
    g0 = t(1. + randn(r, k, scale=0.1)).to(cuda)
    w0 = t(randn(r, hid, k, scale=k ** -0.5)).to(cuda).to(BF16)
    g1 = t(1. + randn(r, hid, scale=0.1)).to(cuda)
    w1 = t(randn(r, k, hid, scale=hid ** -0.5)).to(cuda).to(BF16)
    return x, g0, w0, g1, w1


@pytest.mark.cuda
@pytest.mark.parametrize('rows,k,hid,cluster', FF_CASES)
def test_fused_feedforward_kernel_matches_plain(cuda, rows, k, hid, cluster):
    """Within the bound of the plain bf16 chain, and the same bits on a
    second run (the partials are summed in rank order)."""
    assert fn.ff_tiles(rows, k, hid).cluster == cluster
    assert {c[-1] for c in FF_CASES} == set(fn.FF_CLUSTERS)
    x, g0, w0, g1, w1 = _ff_inputs(cuda, rows, k, hid)

    def run(x, w0, w1):
        return fn.fused_feedforward(x, g0, w0, g1, w1, 1e-3)

    def plain(x, w0, w1):
        return fn.feedforward_reference(x, g0, w0, g1, w1, 1e-3)

    _check(run, plain, (x, w0, w1), (x.float(), w0.float(), w1.float()), fn.KERNEL)
    assert torch.equal(run(x, w0, w1), run(x, w0, w1))


@pytest.mark.cuda
def test_fused_feedforward_reads_packed_weights(cuda):
    """`packed=` hands the kernel bf16 weights made earlier: the result is
    the one it computes from the fp32 weights itself."""
    x, g0, w0, g1, w1 = _ff_inputs(cuda, 288, 512, 2048, seed=6)
    w0f, w1f = w0.float(), w1.float()
    packed = fn.pack_ff_weights(w0f, w1f)
    assert torch.equal(fn.fused_feedforward(x, g0, w0f, g1, w1f, 1e-3, packed=packed),
                       fn.fused_feedforward(x, g0, w0f, g1, w1f, 1e-3))


@pytest.mark.cuda
@pytest.mark.parametrize('which', ['transformer', 'perceiver', 'transformer_384'])
def test_feedforward_modules_run_the_kernel_right(cuda, monkeypatch, which):
    """BaseUnet64's 32^2 TransformerBlock (batch 2), a Perceiver at its
    width and the 384-wide TransformerBlock of a default Unet at dim 48 (the
    staged route), bf16 with the feedforward gate open, held to the same
    module in fp32 as the plain route (gate closed) is; a second call reads
    the kept bf16 weights and gives the same bits."""
    torch.manual_seed(16)
    g = torch.Generator(device=cuda).manual_seed(17)
    if which.startswith('transformer'):
        width = 384 if which == 'transformer_384' else 512

        def build(dt):
            return blocks.TransformerBlock(width, depth=1, heads=8, dim_head=64, ff_mult=2.,
                                           dtype=dt)
        x = torch.randn((2, 32, 32, width), generator=g, device=cuda)
    else:
        def build(dt):
            return blocks.PerceiverResampler(512, depth=2, dim_head=64, heads=8, num_latents=32,
                                             dtype=dt)
        x = torch.randn((4, 256, 512), generator=g, device=cuda)
    ref = build(torch.float32).to(cuda)
    fast = build(BF16).to(cuda)
    fast.load_state_dict(ref.state_dict())
    with torch.no_grad():
        truth = ref(x)
        before = _build.LAUNCHES[fn.KERNEL]
        out = fast(x.to(BF16))
        assert _build.LAUNCHES[fn.KERNEL] > before
        assert torch.equal(fast(x.to(BF16)), out)
        monkeypatch.setattr(blocks, 'fused_feedforward_available', lambda *a, **k: False)
        plain = fast(x.to(BF16))
    assert max_abs(out.float(), truth) <= _bound(max_abs(plain.float(), truth))


# (rows, k, hid) that the gate admits and the cluster kernel refuses: ff_mult
# 2 at width 384 (a default Unet's 384-wide stage, also ragged against the
# 128-row product tile), k past 512, hid 5 x 256 and 3 x 128, the widest k
# and the widest hid the 4 MB of weights allow, one row block of 8
STAGED_CASES = [(64, 384, 768), (8200, 384, 768), (64, 1024, 1024), (64, 640, 1280),
                (72, 512, 384), (200, 8192, 128), (72, 128, 8192), (8, 256, 768)]


@pytest.mark.cuda
@pytest.mark.parametrize('rows,k,hid', STAGED_CASES)
def test_fused_feedforward_staged_route_matches_plain(cuda, rows, k, hid):
    """The staged route, within the bound of the plain bf16 chain and the
    same bits on a second run."""
    assert fn.fused_feedforward_available(rows, k, hid) and fn.ff_tiles(rows, k, hid) is None
    x, g0, w0, g1, w1 = _ff_inputs(cuda, rows, k, hid)

    def run(x, w0, w1):
        return fn.fused_feedforward(x, g0, w0, g1, w1, 1e-3)

    def plain(x, w0, w1):
        return fn.feedforward_reference(x, g0, w0, g1, w1, 1e-3)

    _check(run, plain, (x, w0, w1), (x.float(), w0.float(), w1.float()), fn.KERNEL)
    assert torch.equal(run(x, w0, w1), run(x, w0, w1))


@pytest.mark.cuda
@pytest.mark.parametrize('k,hid', [(192, 384), (256, 320)])
def test_fused_feedforward_raises_outside_the_gate(cuda, k, hid):
    """Widths the gate refuses (not multiples of 128) raise on CUDA; they
    never take the plain chain there."""
    assert not fn.fused_feedforward_available(64, k, hid)
    x, g0, w0, g1, w1 = _ff_inputs(cuda, 64, k, hid)
    with pytest.raises(ValueError):
        fn.fused_feedforward(x, g0, w0, g1, w1, 1e-3)


@pytest.mark.cuda
def test_wrappers_raise_on_wrong_dtype(cuda):
    x = torch.zeros(1, 8, 64, 32, device=cuda)
    with pytest.raises(TypeError):
        c2d.conv2d_same(x, torch.zeros(3, 3, 32, 32, device=cuda), None)


def _bound(err_plain):
    return max(2 * err_plain, 1e-3)


def _flash_bwd_inputs(cuda, b, rows, nk, d, seed):
    """bf16-valued q, k (normalised rows, as on the cosine path), v, dO, and
    the fp32 forward's lse and delta, which both versions then share."""
    r = rng(seed)
    q, k = (fa.l2norm_scale(t(randn(r, b, n, d)).to(cuda), torch.ones(d, device=cuda))
            for n in (rows, nk))
    v, do = t(randn(r, b, nk, d)).to(cuda), t(randn(r, b, rows, d)).to(cuda)
    q, k, v, do = (x.to(BF16).float() for x in (q, k, v, do))
    out, lse = fa.flash_rows_reference(q, k, v, 8., return_lse=True)
    return q, k, v, do, lse, fa._delta(do, out)


def _splits(cuda, b, rows, nk):
    sm_count = torch.cuda.get_device_properties(cuda).multi_processor_count
    return fa.bwd_splits(b, rows, nk, sm_count)


# (b, rows, nk, d) as FLASH_CASES, with the video mid_attn (4, 32768, 4097,
# 64); (2, 2048, 1063, 64) splits the rows of its dK/dV pass (S > 1) and
# (8, 1024, 4097, 64) does not (S = 1), as the split test asserts
FLASH_BWD_CASES = [(2, 2048, 1063, 64), (2, 512, 77, 32), (2, 200, 200, 40),
                   (4, 32768, 4097, 64), (1, 130, 1, 16), (1, 200, 65, 128),
                   (8, 1024, 4097, 64), (2, 1000, 63, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize('b,rows,nk,d', FLASH_BWD_CASES)
def test_flash_backward_kernel_matches_plain(cuda, b, rows, nk, d):
    q, k, v, do, lse, delta = _flash_bwd_inputs(cuda, b, rows, nk, d, seed=6)
    before = _build.LAUNCHES[fa.BWD_KERNEL]
    got = fa.flash_rows_backward(*(x.to(BF16) for x in (q, k, v, do)), lse, delta, 8.)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[fa.BWD_KERNEL] == before + 1
    truth = fa.flash_rows_backward_reference(q, k, v, do, lse, delta, 8.)
    plain = fa.flash_rows_backward_reference(*(x.to(BF16) for x in (q, k, v, do)), lse,
                                             delta, 8.)
    for name, g, p, ref in zip(('dq', 'dk', 'dv'), got, plain, truth):
        assert g.shape == ref.shape and g.dtype == BF16
        err_k, err_p = max_abs(g.float(), ref), max_abs(p.float(), ref)
        assert err_k <= _bound(err_p), (name, err_k, err_p)


@pytest.mark.cuda
def test_flash_backward_splits_at_the_test_shapes(cuda):
    assert _splits(cuda, 2, 2048, 1063) > 1
    assert _splits(cuda, 8, 1024, 4097) == 1


@pytest.mark.cuda
def test_flash_backward_is_deterministic(cuda):
    """No atomics: two calls on the same inputs give bitwise-equal gradients,
    with the rows split across blocks (S > 1)."""
    q, k, v, do, lse, delta = _flash_bwd_inputs(cuda, 2, 2048, 1063, 64, seed=7)
    assert _splits(cuda, 2, 2048, 1063) > 1
    args = (*(x.to(BF16) for x in (q, k, v, do)), lse, delta, 8.)
    first = fa.flash_rows_backward(*args)
    second = fa.flash_rows_backward(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(('dq', 'dk', 'dv'), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize('b,rows,nk,d', [(2, 2048, 1063, 64), (2, 200, 200, 40), (1, 130, 1, 16),
                                        (1, 200, 65, 128), (8, 1024, 4097, 64)])
def test_flash_forward_lse_matches_plain(cuda, b, rows, nk, d):
    r = rng(8)
    q, k, v = (t(randn(r, b, n, d)).to(cuda).to(BF16) for n in (rows, nk, nk))
    qs, ks = (t(1. + randn(r, d, scale=0.1)).to(cuda) for _ in range(2))
    kn = fa.l2norm_scale(k, ks)
    before = _build.LAUNCHES[fa.KERNEL]
    _, lse = fa._rows_forward(q, kn, v, 8., qs, with_lse=True)
    assert _build.LAUNCHES[fa.KERNEL] == before + 1
    _, truth = fa.flash_rows_reference(q.float(), kn.float(), v.float(), 8., qs,
                                       return_lse=True)
    _, plain = fa.flash_rows_reference(q, kn, v, 8., qs, return_lse=True)
    assert lse.shape == (b, rows) and lse.dtype == torch.float32
    assert max_abs(lse, truth) <= _bound(max_abs(plain, truth))


def _grads(fn, inputs):
    """Gradients of sum(fn(*inputs) * cotangent) with respect to every input."""
    leaves = [x.detach().requires_grad_() for x in inputs]
    out = fn(*leaves)
    cot = torch.randn(out.shape, generator=torch.Generator(out.device).manual_seed(9),
                      device=out.device)
    (out.float() * cot).sum().backward()
    return [x.grad for x in leaves]


def _check_grads(kernel_fn, plain_fn, bf16_inputs, name):
    before = _build.LAUNCHES[name]
    got = _grads(kernel_fn, bf16_inputs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] > before
    truth = _grads(plain_fn, [x.float() for x in bf16_inputs])
    plain = _grads(plain_fn, bf16_inputs)
    for i, (g, p, ref) in enumerate(zip(got, plain, truth)):
        assert g is not None and bool(torch.isfinite(g).all()), i
        err_k, err_p = max_abs(g.float(), ref), max_abs(p.float(), ref)
        assert err_k <= _bound(err_p), (i, err_k, err_p)


@pytest.mark.cuda
def test_flash_function_gradients_match_plain(cuda):
    r = rng(10)
    rows, nk, d = 2048, 1063, 64
    inputs = [t(randn(r, 2, n, d)).to(cuda).to(BF16) for n in (rows, nk, nk)]
    inputs += [t(1. + randn(r, d, scale=0.1)).to(cuda) for _ in range(2)]

    def plain(q, k, v, qs, ks):
        return fa.flash_rows_reference(q, fa.l2norm_scale(k, ks), v, 8., qs)

    _check_grads(lambda *a: fa.flash_cosine_mqa_rows(*a, 8.), plain, inputs, fa.BWD_KERNEL)


@pytest.mark.cuda
def test_conv2d_function_gradients_match_plain(cuda):
    r = rng(11)
    x = t(randn(r, 2, 16, 128, 128)).to(cuda).to(BF16)
    w = t(randn(r, 3, 3, 128, 120, scale=(9 * 128) ** -0.5)).to(cuda).to(BF16)
    bias = t(randn(r, 120, scale=0.1)).to(cuda)
    _check_grads(c2d.conv2d_same, c2d.conv2d_same_reference, [x, w, bias], c2d.KERNEL)


@pytest.mark.cuda
def test_fused_feedforward_function_gradients_match_plain(cuda):
    r = rng(12)
    k, hid = 256, 512
    inputs = [t(randn(r, 300, k)).to(cuda).to(BF16), t(1. + randn(r, k, scale=0.1)).to(cuda),
              t(randn(r, hid, k, scale=k ** -0.5)).to(cuda),
              t(1. + randn(r, hid, scale=0.1)).to(cuda),
              t(randn(r, k, hid, scale=hid ** -0.5)).to(cuda)]

    def run(x, g0, w0, g1, w1):
        return fn.fused_feedforward(x, g0, w0, g1, w1, 1e-3)

    def plain(x, g0, w0, g1, w1):
        return fn.feedforward_reference(x, g0, w0, g1, w1, 1e-3)

    _check_grads(run, plain, inputs, fn.KERNEL)


@pytest.mark.cuda
def test_every_unet_parameter_gets_a_gradient_through_the_kernels(cuda):
    """A small bf16 Unet whose forward reaches all three forward kernels:
    after one backward every parameter holds a finite gradient, and the
    flash backward ran."""
    torch.manual_seed(0)
    unet = it.Unet(dim=128, dim_mults=(1, 2), num_resnet_blocks=1, layer_attns=(False, True),
                   layer_cross_attns=(False, True), attn_heads=2, attn_dim_head=64,
                   text_embed_dim=64, cond_dim=128, max_text_len=16, attn_pool_num_latents=8,
                   dtype=BF16, device=cuda)
    with torch.no_grad():
        unet.final_conv.weight.normal_(0., 0.02)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((2, 128, 128, 3), generator=g, device=cuda)
    time = torch.rand((2,), generator=g, device=cuda)
    emb = torch.randn((2, 16, 64), generator=g, device=cuda)
    before = dict(_build.LAUNCHES)
    out = unet(x, time, text_embeds=emb, cond_drop_prob=0.5, generator=g)
    out.float().square().mean().backward()
    torch.cuda.synchronize()
    for name in (fa.KERNEL, fa.BWD_KERNEL, c2d.KERNEL, fn.KERNEL):
        assert _build.LAUNCHES[name] > before.get(name, 0), name
    for name, p in unet.named_parameters():
        assert p.grad is not None, name
        assert bool(torch.isfinite(p.grad).all()), name


def _temporal_inputs(cuda, P, f, h, d, seed):
    """bf16 q, k, v for P pixels of f frames and h heads, fp32 gains, and a
    causal DynamicPositionBias-like table with the null column first."""
    r = rng(seed)
    nk = f + 1
    q = t(randn(r, P, f, h * d)).to(cuda).to(BF16)
    k, v = (t(randn(r, P, nk, d)).to(cuda).to(BF16) for _ in range(2))
    qs, ks = (t(1. + randn(r, d, scale=0.1)).to(cuda) for _ in range(2))
    causal = torch.ones((f, nk), dtype=torch.bool, device=cuda).triu(2)
    bias = fa.build_grouped_bias(t(randn(r, h, f, nk)).to(cuda), causal)
    return q, k, v, qs, ks, bias


@pytest.mark.cuda
@pytest.mark.parametrize('P,f,h,d', [(512, 16, 8, 64), (100, 5, 3, 40), (300, 8, 2, 16)])
def test_temporal_kernel_matches_plain(cuda, P, f, h, d):
    q, k, v, qs, ks, bias = _temporal_inputs(cuda, P, f, h, d, seed=13)

    def plain(q, k, v):
        return fa.temporal_attention_reference(q, fa.l2norm_scale(k, ks), v, qs, bias, 8., h)

    _check(lambda q, k, v: fa.flash_grouped_cosine(q, k, v, qs, ks, bias, 8., h), plain,
           (q, k, v), (q.float(), k.float(), v.float()), fa.TEMPORAL_KERNEL)


@pytest.mark.cuda
def test_temporal_function_gradients_match_plain(cuda):
    q, k, v, qs, ks, bias = _temporal_inputs(cuda, 512, 16, 8, 64, seed=14)

    def plain(q, k, v, qs, ks, bias):
        return fa.temporal_attention_reference(q, fa.l2norm_scale(k, ks), v, qs, bias, 8., 8)

    _check_grads(lambda *a: fa.flash_grouped_cosine(*a, 8., 8), plain,
                 [q, k, v, qs, ks, bias], fa.TEMPORAL_KERNEL)


@pytest.mark.cuda
def test_temporal_wrapper_raises_outside_its_limits(cuda):
    q, k, v, qs, ks, bias = _temporal_inputs(cuda, 4, 4, 2, 32, seed=15)
    with pytest.raises(TypeError):
        fa.flash_grouped_cosine(q.float(), k.float(), v.float(), qs, ks, bias, 8., 2)
    with pytest.raises(ValueError):
        fa.flash_grouped_cosine(q[:, :, ::2], k, v, qs, ks, bias, 8., 1)
    big = torch.zeros(2, 20, 8 * 32, device=cuda, dtype=BF16)   # 160 rows
    kv = torch.zeros(2, 21, 32, device=cuda, dtype=BF16)
    with pytest.raises(ValueError):
        fa.flash_grouped_cosine(big, kv, kv, qs, ks, torch.zeros(8, 20, 21, device=cuda), 8., 8)


# --- the fused temporal LayerNorm fold and out-norm unfold (kernels 12, 13) ---------------

# the video training sites at batch 4 (16^2 and 32^2), then a ragged lane
# group (c 136) and a row of 4 vectors per lane (c 1024)
LAYOUT_SHAPES = [(4, 16, 32, 32, 128), (4, 16, 16, 16, 256), (1, 3, 5, 7, 136),
                 (2, 2, 4, 4, 1024)]


def _layout_inputs(cuda, shape, seed):
    r = rng(seed)
    b, f, h, w, c = shape
    x = t(randn(r, *shape)).to(cuda).to(BF16)
    out = t(randn(r, b * h * w, f, c, scale=2.)).to(cuda).to(BF16)
    return x, out, t(1. + randn(r, c, scale=0.1)).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize('shape', LAYOUT_SHAPES)
def test_temporal_layout_kernels_match_plain(cuda, shape):
    x, out, g = _layout_inputs(cuda, shape, seed=16)
    _check(lambda x: tl.fused_ln_transpose(x, g, 1e-3),
           lambda x: tl.ln_transpose_reference(x, g, 1e-3), (x,), (x.float(),), tl.LN_T_KERNEL)
    _check(lambda o, x: tl.fused_norm_untranspose(o, x, g, 1e-3),
           lambda o, x: tl.norm_untranspose_reference(o, x, g, 1e-3), (out, x),
           (out.float(), x.float()), tl.NORM_UT_KERNEL)


@pytest.mark.cuda
def test_temporal_layout_function_gradients_match_plain(cuda):
    """The Functions' backward is the unfused chain (fold, then LayerNorm in
    the input's dtype; for kernel 13 the unfold and the residual), as in the
    JAX package; its gradients are held to that chain's fp32 gradients."""
    x, out, g = _layout_inputs(cuda, (4, 16, 16, 16, 256), seed=17)

    def fold_chain(x, g):
        return fn.layernorm(tl._fold(x), g, 1e-3)

    def unfold_chain(o, x, g):
        return tl._unfold(fn.layernorm(o, g, 1e-3), x.shape) + x

    _check_grads(lambda x, g: tl.fused_ln_transpose(x, g, 1e-3), fold_chain, [x, g],
                 tl.LN_T_KERNEL)
    _check_grads(lambda o, x, g: tl.fused_norm_untranspose(o, x, g, 1e-3), unfold_chain,
                 [out, x, g], tl.NORM_UT_KERNEL)


@pytest.mark.cuda
def test_temporal_layout_wrappers_raise_outside_the_gate(cuda):
    x, out, g = _layout_inputs(cuda, (2, 4, 4, 4, 128), seed=18)
    with pytest.raises(TypeError):
        tl.fused_ln_transpose(x.float(), g, 1e-3)
    with pytest.raises(ValueError):   # c % 8 != 0
        tl.fused_ln_transpose(x[..., :100], g[:100], 1e-3)
    with pytest.raises(ValueError):   # more than one warp's row
        wide = torch.zeros(1, 2, 2, 2, 4096, device=cuda, dtype=BF16)
        tl.fused_ln_transpose(wide, torch.ones(4096, device=cuda), 1e-3)
    with pytest.raises(ValueError):   # out does not fold res
        tl.fused_norm_untranspose(out[:-1], x, g, 1e-3)
    with pytest.raises(ValueError):
        tl.fused_ln_transpose(x[0], g, 1e-3)   # 4-D


# --- ChanRMSNorm·FiLM·SiLU, row LayerNorm, LN<->matmul (kernels 8, 9, 11) ------------------

def _film_inputs(cuda, shape, seed):
    """bf16 x, fp32 gamma, and scale/shift as the ResnetBlock hands them over:
    the two strided (b, 1, 1, C) halves of one (b, 2C) time-MLP output."""
    r = rng(seed)
    b, c = shape[0], shape[-1]
    x = t(randn(r, *shape)).to(cuda).to(BF16)
    gamma = t(1. + randn(r, c, scale=0.1)).to(cuda)
    film = t(randn(r, b, 2 * c, scale=0.5)).to(cuda).to(BF16)
    scale, shift = film[:, None, None, :].chunk(2, dim=-1)
    return x, gamma, scale, shift


# EDM path sites: BaseUnet64 64^2 c 512, its deepest up level (8^2, c 3584),
# SRUnet256's 256^2 c 128 at batch 8; then ragged row counts at c 384 and 2560
FILM_SHAPES = [(8, 64, 64, 512), (8, 8, 8, 3584), (8, 256, 256, 128), (3, 5, 7, 384),
               (1, 3, 3, 2560)]


@pytest.mark.cuda
@pytest.mark.parametrize('shape', FILM_SHAPES)
@pytest.mark.parametrize('film', [True, False], ids=['film', 'no_film'])
def test_film_norm_kernel_matches_plain(cuda, shape, film):
    x, gamma, scale, shift = _film_inputs(cuda, shape, seed=20)
    if not film:
        scale = shift = None

    def run(x):
        return fn.fused_film_norm(x, gamma, scale, shift)

    def plain(x):
        return fn.film_norm_reference(x, gamma, scale, shift)

    _check(run, plain, (x,), (x.float(),), fn.FILM_KERNEL)


@pytest.mark.cuda
def test_film_norm_function_gradients_match_plain(cuda):
    x, gamma, scale, shift = _film_inputs(cuda, (4, 16, 16, 512), seed=21)
    _check_grads(fn.fused_film_norm, fn.film_norm_reference,
                 [x, gamma, scale.contiguous(), shift.contiguous()], fn.FILM_KERNEL)


# the EDM path's LayerNorm sites (BaseUnet64's 32^2 pre-norm at batch 8, its
# 8^2 c 2048 norms), a ragged row count, and c 4096 (the kernel's widest)
LN_SHAPES = [(8192, 1024), (512, 2048), (37, 384), (64, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize('rows,c', LN_SHAPES)
@pytest.mark.parametrize('stable', [False, True], ids=['plain', 'stable'])
def test_layernorm_kernel_matches_plain(cuda, rows, c, stable):
    r = rng(22)
    x = t(randn(r, rows, c) + 0.5).to(cuda).to(BF16)
    g = t(1. + randn(r, c, scale=0.1)).to(cuda)
    _check(lambda x: fn.fused_layernorm(x, g, stable, 1e-3),
           lambda x: fn.layernorm_reference(x, g, stable, 1e-3), (x,), (x.float(),),
           fn.LN_KERNEL)


@pytest.mark.cuda
@pytest.mark.parametrize('stable', [False, True], ids=['plain', 'stable'])
def test_layernorm_function_gradients_match_plain(cuda, stable):
    r = rng(23)
    inputs = [t(randn(r, 2048, 512) + 0.5).to(cuda).to(BF16),
              t(1. + randn(r, 512, scale=0.1)).to(cuda)]
    _check_grads(lambda x, g: fn.fused_layernorm(x, g, stable, 1e-3),
                 lambda x, g: fn.layernorm_reference(x, g, stable, 1e-3), inputs, fn.LN_KERNEL)


# (rows, k, n): the attention pre-norm into to_q + to_kv at 32^2 and 8^2
# (BaseUnet64, batch 8), the out-projection into the out-norm at 32^2 and
# 8^2, and ragged row counts
LNMM_SHAPES = [(8192, 1024, 640), (512, 2048, 640), (300, 512, 512), (77, 256, 384)]
MMLN_SHAPES = [(8192, 512, 1024), (512, 512, 2048), (300, 512, 384), (77, 1024, 128)]


def _rowblock_inputs(cuda, rows, k, n, seed):
    r = rng(seed)
    x = t(randn(r, rows, k)).to(cuda).to(BF16)
    w = t(randn(r, n, k, scale=k ** -0.5)).to(cuda).to(BF16)
    return x, w, r


@pytest.mark.cuda
@pytest.mark.parametrize('rows,k,n', LNMM_SHAPES)
def test_ln_matmul_kernel_matches_plain(cuda, rows, k, n):
    x, w, r = _rowblock_inputs(cuda, rows, k, n, seed=24)
    g = t(1. + randn(r, k, scale=0.1)).to(cuda)
    _check(lambda x, w: fn.fused_ln_matmul(x, g, w, 1e-3),
           lambda x, w: fn.ln_matmul_reference(x, g, w, 1e-3), (x, w), (x.float(), w.float()),
           fn.LNMM_KERNEL)


@pytest.mark.cuda
@pytest.mark.parametrize('rows,k,n', MMLN_SHAPES)
def test_matmul_ln_kernel_matches_plain(cuda, rows, k, n):
    x, w, r = _rowblock_inputs(cuda, rows, k, n, seed=25)
    g = t(1. + randn(r, n, scale=0.1)).to(cuda)
    _check(lambda x, w: fn.fused_matmul_ln(x, w, g, 1e-3),
           lambda x, w: fn.matmul_ln_reference(x, w, g, 1e-3), (x, w), (x.float(), w.float()),
           fn.MMLN_KERNEL)


@pytest.mark.cuda
def test_ln_matmul_function_gradients_match_plain(cuda):
    x, w, r = _rowblock_inputs(cuda, 1024, 512, 640, seed=26)
    gk, gn = (t(1. + randn(r, m, scale=0.1)).to(cuda) for m in (512, 640))
    _check_grads(lambda x, g, w: fn.fused_ln_matmul(x, g, w, 1e-3),
                 lambda x, g, w: fn.ln_matmul_reference(x, g, w, 1e-3), [x, gk, w],
                 fn.LNMM_KERNEL)
    y, w2, _ = _rowblock_inputs(cuda, 1024, 512, 640, seed=27)
    _check_grads(lambda x, w, g: fn.fused_matmul_ln(x, w, g, 1e-3),
                 lambda x, w, g: fn.matmul_ln_reference(x, w, g, 1e-3), [y, w2, gn],
                 fn.MMLN_KERNEL)


@pytest.mark.cuda
def test_fused_norm_wrappers_raise_outside_their_limits(cuda):
    x, gamma, scale, shift = _film_inputs(cuda, (2, 4, 4, 256), seed=28)
    with pytest.raises(TypeError):
        fn.fused_film_norm(x.float(), gamma, None, None)
    with pytest.raises(TypeError):
        fn.fused_film_norm(x, gamma, scale.float(), shift.float())
    with pytest.raises(ValueError):   # C past one warp's row
        wide = torch.zeros(1, 2, 2, 8192, device=cuda, dtype=BF16)
        fn.fused_film_norm(wide, torch.ones(8192, device=cuda))
    with pytest.raises(ValueError):
        fn.fused_film_norm(x, gamma, scale, None)
    with pytest.raises(TypeError):
        fn.fused_layernorm(x.float(), gamma, False, 1e-3)
    w = torch.zeros(640, 512, device=cuda, dtype=BF16)
    with pytest.raises(ValueError):   # k does not match
        fn.fused_ln_matmul(torch.zeros(16, 256, device=cuda, dtype=BF16),
                           torch.ones(256, device=cuda), w, 1e-3)
    with pytest.raises(ValueError):   # k + n past shared memory
        fn.fused_matmul_ln(torch.zeros(16, 4096, device=cuda, dtype=BF16),
                           torch.zeros(4096, 4096, device=cuda, dtype=BF16),
                           torch.ones(4096, device=cuda), 1e-3)


@pytest.mark.cuda
def test_edm_sample_through_the_film_kernel(cuda):
    """A small bf16 two-stage EDM cascade with `fused_film=True` (c 128 and
    256) samples finite images in [0, 1], and every Block went through
    kernel 8."""
    torch.manual_seed(0)
    cfg = dict(dim=128, dim_mults=(1, 2), num_resnet_blocks=1, layer_attns=(False, True),
               layer_cross_attns=(False, True), attn_heads=2, attn_dim_head=64,
               text_embed_dim=64, cond_dim=128, max_text_len=16, attn_pool_num_latents=8,
               fused_film=True, dtype=BF16, device=cuda)
    unets = (it.Unet(**cfg), it.Unet(**cfg, lowres_cond=True, memory_efficient=True))
    for unet in unets:
        with torch.no_grad():
            unet.final_conv.weight.normal_(0., 0.02)
    imagen = it.ElucidatedImagen(unets, image_sizes=(32, 64), text_embed_dim=64,
                                 num_sample_steps=(4, 3), device=cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(1)
    emb = torch.randn((2, 16, 64), generator=g, device=cuda)
    before = _build.LAUNCHES[fn.FILM_KERNEL]
    images = imagen.sample(text_embeds=emb, cond_scale=3., generator=g)
    torch.cuda.synchronize()
    assert images.shape == (2, 64, 64, 3)
    assert bool(torch.isfinite(images).all()) and images.min() >= 0. and images.max() <= 1.
    assert _build.LAUNCHES[fn.FILM_KERNEL] > before


# --- kernel 14 (CrossEmbed stem) and kernel 7 (tiny-cout conv, channel-first out) --------

# The six site shapes (the SR-1024 stem; SRUnet256's at batch 4 and 8;
# BaseUnet64's 3-channel stem, its 15 x 15 scale in four sets of 32 channels;
# the video U-Net's at 32 and 64 frames), then c = 3, 6 and 8; ragged tiles
# with H and W of 4 x odd; a scale whose d falls short of its N (20 of 32,
# 10 and 9 of 16, 24 of 32); odd channel offsets; one scale and four
STEM_CASES = [((2, 1024, 1024, 6), (3, 7, 15), (64, 32, 32)),   # the SR-1024 stem
              ((2, 36, 100, 3), (3, 7, 15), (20, 10, 10)),      # ragged tiles and chunks
              ((1, 20, 12, 8), (1, 5), (7, 9)),
              ((4, 256, 256, 6), (3, 7, 15), (64, 32, 32)),
              ((8, 256, 256, 6), (3, 7, 15), (64, 32, 32)),
              ((8, 64, 64, 3), (3, 7, 15), (256, 128, 128)),
              ((32, 64, 64, 3), (3, 7, 15), (32, 16, 16)),
              ((64, 64, 64, 3), (3, 7, 15), (32, 16, 16)),
              ((1, 12, 28, 6), (9,), (24,)),
              ((2, 36, 44, 3), (1, 5, 9, 13), (8, 8, 8, 16))]


def _stem_inputs(cuda, shape, ks, ds, seed=20):
    r = rng(seed)
    c = shape[-1]
    x = t(randn(r, *shape)).to(cuda).to(BF16)
    ws = [t(randn(r, k, k, c, d, scale=(k * k * c) ** -0.5)).to(cuda).to(BF16)
          for k, d in zip(ks, ds)]
    return [x, t(randn(r, sum(ds), scale=0.1)).to(cuda).to(BF16), *ws]


def _stem_run(x, bias, *ws):
    return stem.cross_embed_stem(x, list(ws), bias)


def _stem_plain(x, bias, *ws):
    return stem.cross_embed_stem_reference(x, list(ws), bias)


@pytest.mark.cuda
@pytest.mark.parametrize('shape,ks,ds', STEM_CASES)
def test_stem_kernel_matches_plain(cuda, shape, ks, ds):
    inputs = _stem_inputs(cuda, shape, ks, ds)
    _check(_stem_run, _stem_plain, inputs, [x.float() for x in inputs], stem.KERNEL)
    assert torch.equal(_stem_run(*inputs), _stem_run(*inputs))


CF_CASES = [((2, 1024, 1024, 131), 3, 3), ((2, 1024, 1024, 128), 3, 3),
            ((1, 37, 100, 131), 5, 3), ((1, 20, 30, 40), 8, 5)]


def _cf_inputs(cuda, shape, cout, k, seed=21):
    r = rng(seed)
    cin = shape[-1]
    return [t(randn(r, *shape)).to(cuda).to(BF16),
            t(randn(r, k, k, cin, cout, scale=(k * k * cin) ** -0.5)).to(cuda).to(BF16),
            t(randn(r, cout, scale=0.1)).to(cuda).to(BF16)]


@pytest.mark.cuda
@pytest.mark.parametrize('shape,cout,k', CF_CASES)
def test_cf_conv_kernel_matches_plain(cuda, shape, cout, k):
    inputs = _cf_inputs(cuda, shape, cout, k)
    _check(c2d.conv2d_same_cf, c2d.conv2d_same_cf_reference, inputs,
           [x.float() for x in inputs], c2d.CF_KERNEL)
    x, w, _ = inputs   # no bias
    _check(lambda x, w: c2d.conv2d_same_cf(x, w, None),
           lambda x, w: c2d.conv2d_same_cf_reference(x, w, None), (x, w),
           (x.float(), w.float()), c2d.CF_KERNEL)


@pytest.mark.cuda
def test_stem_and_cf_function_gradients_match_plain(cuda):
    _check_grads(_stem_run, _stem_plain, _stem_inputs(cuda, (2, 64, 64, 6), (3, 7, 15),
                                                      (16, 8, 8)), stem.KERNEL)
    _check_grads(c2d.conv2d_same_cf, c2d.conv2d_same_cf_reference,
                 _cf_inputs(cuda, (2, 64, 128, 131), 3, 3), c2d.CF_KERNEL)


@pytest.mark.cuda
def test_stem_and_cf_wrappers_raise_on_wrong_dtype_or_device(cuda):
    x, bias, *ws = _stem_inputs(cuda, (1, 16, 16, 6), (3, 7, 15), (8, 4, 4))
    with pytest.raises(TypeError):
        stem.cross_embed_stem(x.float(), ws, bias)
    with pytest.raises(ValueError):
        stem.cross_embed_stem(x, [w.cpu() for w in ws], bias)
    with pytest.raises(ValueError):   # a kernel past the shared-memory limit
        stem.cross_embed_stem(x, [ws[0], t(randn(rng(1), 17, 17, 6, 4)).to(cuda).to(BF16)],
                              bias[:12])
    x, w, b = _cf_inputs(cuda, (1, 16, 16, 32), 3, 3)
    with pytest.raises(TypeError):
        c2d.conv2d_same_cf(x.float(), w, b)
    with pytest.raises(ValueError):
        c2d.conv2d_same_cf(x, w.cpu(), b)
    with pytest.raises(ValueError):   # cout past 8
        c2d.conv2d_same_cf(x, torch.zeros((3, 3, 32, 9), device=cuda, dtype=BF16), None)


@pytest.mark.cuda
def test_offloaded_sr_cascade_samples_through_the_stem_kernel(cuda):
    """A small bf16 NullUnet -> SR cascade, the SR unet parked on the host: sampled from `start_at_unet_number=2` with
    `offload_inactive_unets`, it gives the sample of the unet on the card,
    through kernel 14, and the unet is back on the host after."""
    torch.manual_seed(0)
    cfg = dict(dim=128, dim_mults=(1, 2), num_resnet_blocks=1, layer_attns=False,
               layer_cross_attns=(False, True), attn_heads=2, attn_dim_head=64,
               text_embed_dim=64, cond_dim=128, max_text_len=16, attn_pool_num_latents=8,
               memory_efficient=True, dtype=BF16, device=cuda)
    imagen = it.Imagen((it.NullUnet(device=cuda), it.Unet(**cfg, lowres_cond=True)),
                       image_sizes=(32, 64), text_embed_dim=64, timesteps=(4, 3),
                       device=cuda).eval()
    with torch.no_grad():
        imagen.unets[1].final_conv.weight.normal_(0., 0.02)
    g = torch.Generator(device=cuda).manual_seed(1)
    emb = torch.randn((2, 16, 64), generator=g, device=cuda)
    start = torch.rand((2, 32, 32, 3), generator=g, device=cuda)
    kw = dict(text_embeds=emb, cond_scale=3., start_at_unet_number=2, start_image_or_video=start)
    before = _build.LAUNCHES[stem.KERNEL]
    on_card = imagen.sample(**kw, generator=torch.Generator(device=cuda).manual_seed(2))
    assert _build.LAUNCHES[stem.KERNEL] - before == 3   # one per step
    imagen.unets[1].to('cpu')
    assert imagen.device.type == 'cuda'
    offloaded = imagen.sample(**kw, offload_inactive_unets=True,
                              generator=torch.Generator(device=cuda).manual_seed(2))
    torch.cuda.synchronize()
    assert all(p.device.type == 'cpu' for p in imagen.unets[1].parameters())
    assert on_card.shape == (2, 64, 64, 3) and bool(torch.isfinite(on_card).all())
    assert torch.equal(on_card, offloaded)
