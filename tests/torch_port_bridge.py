"""Shared helpers for the tests of the PyTorch port (`tests/test_torch_*.py`).

Inputs are made with numpy from a seed and handed to both packages; weights
go from the JAX package to the port through `state_dict_from_jax`. JAX is
imported only inside the helpers that need it, so the GPU tests
(`tests/test_torch_cuda.py`) run where JAX is not installed.
"""
import os
from types import SimpleNamespace

# the tests never download: T5 models are built in code (`tiny_t5`), and
# transformers' TensorFlow backend is not loaded
os.environ.setdefault('HF_HUB_OFFLINE', '1')
os.environ.setdefault('USE_TF', '0')
os.environ.setdefault('USE_FLAX', '0')

import numpy as np
import torch

from imagen_tpu_torch.utils.port_weights import state_dict_from_jax

# tier-1 runs the test files in 6 workers; keep each worker's torch narrow
torch.set_num_threads(2)

# dim-8 configs after tests/test_reference_parity.py, without the linear
# attention that the port does not carry yet
BASE_CFG = dict(
    dim=8, dim_mults=(1, 2), num_resnet_blocks=(1, 2),
    layer_attns=(False, True), layer_cross_attns=(False, True),
    attn_heads=2, attn_dim_head=4, text_embed_dim=16, cond_dim=8,
    max_text_len=8, attn_pool_text=True, attn_pool_num_latents=2,
    learned_sinu_pos_emb_dim=4, memory_efficient=False,
)

SR_CFG = dict(
    dim=8, dim_mults=(1, 2), num_resnet_blocks=1,
    layer_attns=(False, True), layer_cross_attns=(False, True),
    attn_heads=2, attn_dim_head=4, text_embed_dim=16, cond_dim=8,
    max_text_len=8, attn_pool_text=True, attn_pool_num_latents=2,
    learned_sinu_pos_emb_dim=4, memory_efficient=True, lowres_cond=True,
)


def rng(seed):
    return np.random.RandomState(seed)


def randn(r, *shape, scale=1.0):
    return (r.randn(*shape) * scale).astype(np.float32)


def t(a):
    """numpy -> torch (CPU, same dtype)."""
    return torch.from_numpy(np.array(a, order="C"))


def np_(x):
    """torch or jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def max_abs(a, b):
    return float(np.abs(np_(a).astype(np.float64) - np_(b).astype(np.float64)).max())


_GAINS = ('g', 'scale', 'gamma', 'q_scale', 'k_scale')


def random_params(module, *args, seed=0, **kwargs):
    """Seeded numpy params with the structure of `module.init(*args, **kwargs)`.

    The structure comes from `jax.eval_shape` (no compile). Every leaf is
    drawn, so no zero- or one-initialised weight (the final conv is zero-init)
    hides part of the network: kernels ~ N(0, 1/fan_in), gains ~ 1 + N(0, 0.1),
    biases ~ N(0, 0.1), the rest ~ N(0, 1).
    """
    import jax
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))['params']
    r = rng(seed)

    def leaf(path, shape):
        name = path[-1]
        if name == 'kernel':
            return randn(r, *shape, scale=float(np.prod(shape[:-1])) ** -0.5)
        if name in _GAINS:
            return (1. + randn(r, *shape, scale=0.1)).astype(np.float32)
        if name == 'bias':
            return randn(r, *shape, scale=0.1)
        return randn(r, *shape)

    def walk(tree, prefix):
        return {k: walk(v, prefix + (k,)) if isinstance(v, dict)
                else leaf(prefix + (k,), v.shape) for k, v in tree.items()}
    return walk(shapes, ())


def load_into(torch_module, flax_params):
    """Bridge flax params into a port module, strictly."""
    torch_module.load_state_dict(state_dict_from_jax(flax_params), strict=True)
    return torch_module.eval()


def load_block(torch_module, flax_params, flax_path, torch_prefix, video=None):
    """Bridge the params of one block. `flax_path` places them where a Unet
    holds such a block (e.g. 'mid_attn/attn_0'), so the Unet's key table
    applies; `torch_prefix` (e.g. 'mid_attn.layers.0.0.') is then stripped.
    `video` picks the `Unet3D` table where the path does not tell."""
    tree = flax_params
    for name in reversed(flax_path.split('/')):
        tree = {name: tree}
    sd = state_dict_from_jax(tree, video=video)
    if not all(k.startswith(torch_prefix) for k in sd):
        raise KeyError(f'keys outside {torch_prefix!r}: {sorted(sd)[:3]}')
    torch_module.load_state_dict({k[len(torch_prefix):]: v for k, v in sd.items()},
                                 strict=True)
    return torch_module.eval()


def jparams(params):
    import jax
    import jax.numpy as jnp
    return {'params': jax.tree_util.tree_map(jnp.asarray, params)}


def softmax_in_input_dtype(monkeypatch):
    """Both packages take the attention softmax in fp32 whatever the input
    dtype; for a float64 run it keeps float64 on both sides."""
    import jax
    import jax.numpy as jnp
    import imagen_tpu.ops.attention as jattn
    from imagen_tpu_torch.ops import attention as tattn

    def jax_softmax(sim, mask=None, null_tokens=0):
        if mask is not None:
            mask = jnp.pad(mask, ((0, 0), (null_tokens, 0)), constant_values=True)
            sim = jnp.where(mask[:, None, None, :], sim, -jnp.finfo(sim.dtype).max)
        return jax.nn.softmax(sim, axis=-1)

    def torch_softmax(sim, mask=None, null_tokens=0):
        if mask is not None:
            mask = torch.nn.functional.pad(mask, (null_tokens, 0), value=True)
            sim = sim.masked_fill(~mask[:, None, None, :], -torch.finfo(sim.dtype).max)
        return torch.softmax(sim, dim=-1)

    monkeypatch.setattr(jattn, '_masked_softmax_fp32', jax_softmax)
    monkeypatch.setattr(tattn, '_masked_softmax_fp32', torch_softmax)


# --- T5 built in code ------------------------------------------------------------------------

TINY_T5 = 'tiny-t5'


class WordTokenizer:
    """Stands in for `T5Tokenizer.batch_encode_plus`: each word an id in
    [2, 64) from its letters, then the end token 1, padded with 0 to the
    longest text; numpy arrays ('np') or tensors ('pt')."""

    def batch_encode_plus(self, texts, return_tensors='np', padding='longest', max_length=256,
                          truncation=True):
        ids = [[sum(map(ord, w)) % 62 + 2 for w in text.split()][:max_length - 1] + [1]
               for text in texts]
        n = max(map(len, ids))
        input_ids = np.array([x + [0] * (n - len(x)) for x in ids], np.int64)
        mask = np.array([[1] * len(x) + [0] * (n - len(x)) for x in ids], np.int64)
        if return_tensors == 'pt':
            input_ids, mask = torch.from_numpy(input_ids), torch.from_numpy(mask)
        return SimpleNamespace(input_ids=input_ids, attention_mask=mask)


def tiny_t5(d_model=16, seed=0):
    """transformers' `T5EncoderModel` at two layers and width `d_model`, with
    random weights from `seed`."""
    from transformers import T5Config, T5EncoderModel
    torch.manual_seed(seed)
    config = T5Config(vocab_size=64, d_model=d_model, d_kv=4, d_ff=2 * d_model, num_layers=2,
                      num_heads=2, feed_forward_proj='gated-gelu', dropout_rate=0.)
    return T5EncoderModel(config).eval()


class StandInEncoder(torch.nn.Module):
    """An encoder with T5EncoderModel's call (embedding, then a linear layer),
    for tests of the wiring rather than of T5."""

    def __init__(self, d_model=16, seed=0):
        super().__init__()
        torch.manual_seed(seed)
        self.embed = torch.nn.Embedding(64, d_model)
        self.proj = torch.nn.Linear(d_model, d_model)
        self.config = SimpleNamespace(d_model=d_model)

    def forward(self, input_ids, attention_mask=None):
        return SimpleNamespace(last_hidden_state=self.proj(self.embed(input_ids)))


def inject_t5(monkeypatch, model, name=TINY_T5, jax_side=False):
    """Put `model` and a `WordTokenizer` into the port's T5 cache under `name`
    (and the JAX package's, as its torch backend, with `jax_side`)."""
    from imagen_tpu_torch.models import t5
    entry = dict(model=model, tokenizer=WordTokenizer(), config=model.config)
    monkeypatch.setitem(t5.T5_CONFIGS, name, entry)
    if jax_side:
        from imagen_tpu.models import t5 as jt5
        monkeypatch.setitem(jt5.T5_CONFIGS, name, {**entry, 'model': ('torch', model)})
