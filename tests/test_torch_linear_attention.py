"""The port's linear attention against the JAX package's, fp32, on the CPU.

`LinearAttention` with and without context tokens, `CrossAttention(linear=True)`
with a ragged mask, `LinearAttentionTransformerBlock`, its video block and
`ResnetBlock(linear_attn=True)`: seeded weights bridged strictly by
`state_dict_from_jax`, forwards to 1e-5 and the gradients of every weight and
of the input to 1e-4 against `jax.grad` of the JAX module with
`deterministic=True` (its dropout off, the port in eval mode). The JAX
dropout draws from flax's rng and cannot be reproduced, so the port's
train-mode dropout is held to its own properties: keep rate 0.95 and scale
1/0.95, the same masks from the same generator seed, and no draw in eval mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_bridge import load_block, max_abs, randn, random_params, rng, t

from imagen_tpu.models import blocks as jb
from imagen_tpu.models import video_blocks as jvb

from imagen_tpu_torch.models import blocks as tb
from imagen_tpu_torch.models import video_blocks as tvb
from imagen_tpu_torch.utils.port_weights import state_dict_from_jax

DIM, HEADS, DIM_HEAD, CTX = 8, 2, 4, 6


def _case(name):
    """(JAX module, its call's positional inputs, keyword inputs, port module,
    JAX path of the block in a unet, the port's key prefix there, video)."""
    r = rng(len(name))
    fmap = randn(r, 2, 6, 5, DIM)
    context = randn(r, 2, 3, CTX)
    lin = dict(heads=HEADS, dim_head=DIM_HEAD)
    if name == 'linear_attention':
        return (jb.LinearAttention(**lin), (fmap,), {}, tb.LinearAttention(DIM, **lin),
                'down_0_attn/attn_0', 'downs.0.3.layers.0.0.', False)
    if name == 'linear_attention_context':
        return (jb.LinearAttention(**lin, context_dim=CTX), (fmap, context), {},
                tb.LinearAttention(DIM, **lin, context_dim=CTX), 'down_0_attn/attn_0',
                'downs.0.3.layers.0.0.', False)
    if name == 'linear_cross_attention_masked':
        mask = np.ones((2, 3), bool)
        mask[1, 1:] = False
        return (jb.CrossAttention(context_dim=CTX, linear=True, **lin),
                (randn(r, 2, 7, DIM), context), dict(mask=mask),
                tb.CrossAttention(DIM, context_dim=CTX, linear=True, **lin),
                'down_0_init_block/cross_attn', 'downs.0.1.cross_attn.', False)
    if name == 'linear_transformer_block':
        return (jb.LinearAttentionTransformerBlock(depth=2, context_dim=CTX, **lin),
                (fmap, context), {},
                tb.LinearAttentionTransformerBlock(DIM, depth=2, context_dim=CTX, **lin),
                'down_0_attn', 'downs.0.3.', False)
    if name == 'linear_transformer_block_video':
        return (jvb.LinearAttentionTransformerBlockVideo(context_dim=CTX, **lin),
                (randn(r, 2, 3, 4, 5, DIM), context), {},
                tvb.LinearAttentionTransformerBlockVideo(DIM, context_dim=CTX, **lin),
                'down_0_attn', 'downs.0.3.', True)
    assert name == 'resnet_block_linear_cross'
    return (jb.ResnetBlock(dim_out=DIM, cond_dim=CTX, time_cond_dim=12, linear_attn=True,
                           attn_heads=HEADS, attn_dim_head=DIM_HEAD),
            (fmap, randn(r, 2, 12), context), {},
            tb.ResnetBlock(DIM, DIM, cond_dim=CTX, time_cond_dim=12, linear_attn=True,
                           attn_heads=HEADS, attn_dim_head=DIM_HEAD),
            'down_0_init_block', 'downs.0.1.', False)


CASES = ['linear_attention', 'linear_attention_context', 'linear_cross_attention_masked',
         'linear_transformer_block', 'linear_transformer_block_video',
         'resnet_block_linear_cross']


@pytest.mark.parametrize('name', CASES)
def test_module_and_gradients_match_jax(name):
    jmod, args, kwargs, tmod, path, prefix, video = _case(name)
    jargs = [jnp.asarray(a) for a in args]
    jkw = {k: jnp.asarray(v) for k, v in kwargs.items()}
    params = random_params(jmod, *jargs, **jkw, seed=7)
    load_block(tmod.float(), params, path, prefix, video=video)
    if name == 'linear_cross_attention_masked':   # no q_scale/k_scale on this branch
        assert not any('scale' in k for k in tmod.state_dict())
    cot = randn(rng(99), *jmod.apply({'params': params}, *jargs, **jkw).shape)

    def jloss(p, x):
        out = jmod.apply({'params': p}, x, *jargs[1:], **jkw)
        return jnp.sum(out * cot), out

    (_, ref), (jgrads, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        params, jargs[0])
    x = t(args[0]).requires_grad_(True)
    out = tmod(x, *map(t, args[1:]), **{k: t(v) for k, v in kwargs.items()})
    (out * t(cot)).sum().backward()
    assert float(np.abs(np.asarray(ref)).max()) > 0.1
    assert max_abs(out, ref) <= 1e-5

    # every weight's gradient, through the same bridge as the weights
    tree = jax.tree_util.tree_map(np.asarray, jgrads)
    for part in reversed(path.split('/')):
        tree = {part: tree}
    expected = {k[len(prefix):]: v for k, v in state_dict_from_jax(tree, video=video).items()}
    grads = {k: p.grad for k, p in tmod.named_parameters()}
    assert expected.keys() == grads.keys()
    worst = max(max_abs(grads[k], v) for k, v in expected.items())
    assert worst <= 1e-4
    assert max_abs(x.grad, jgx) <= 1e-4


def test_train_mode_dropout():
    """Keep rate 0.95 and scale 1/0.95; the generator's seed fixes the masks
    (and so the output); eval mode draws nothing and drops nothing."""
    torch.manual_seed(0)
    attn = tb.LinearAttention(16, heads=2, dim_head=8)
    x = torch.randn(2, 32, 32, 16)

    attn.train()
    masks = attn.dropout_masks(x.shape, x.device, torch.Generator().manual_seed(1))
    assert masks.shape == (3, *x.shape) and masks.dtype == torch.bool
    assert abs(masks.float().mean().item() - 0.95) < 0.005
    keep = masks[0]
    dropped = attn.to_q[0](x, keep)
    assert torch.equal(dropped[keep], x[keep] / 0.95)
    assert bool((dropped[~keep] == 0).all())

    def run(seed):
        return attn(x, generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))
    assert torch.equal(run(3), attn(x, masks=attn.dropout_masks(
        x.shape, x.device, torch.Generator().manual_seed(3))))

    attn.eval()
    g = torch.Generator().manual_seed(5)
    state = g.get_state()
    out = attn(x, generator=g)
    assert attn.dropout_masks(x.shape, x.device, g) is None
    assert torch.equal(g.get_state(), state)      # nothing drawn
    ones = torch.ones((3, *x.shape), dtype=torch.bool)
    assert not torch.equal(out, attn(x, masks=ones))   # masks scale by 1/0.95 ...
    attn.dropout = 0.
    attn.train()
    assert torch.equal(out, attn(x))                   # ... and eval mode applies none
