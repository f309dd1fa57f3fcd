"""The port's public surface against `imagen_tpu`'s.

`imagen_tpu/**/*.py` is parsed with `ast` (nothing of JAX is imported for
the walk). Every public top-level function and class, every name an
`__init__.py` re-exports, and every public method and property of each
public class (flax's `setup` aside; a method borrowed by assignment, as
`ElucidatedImagen` borrows `Imagen`'s, counts) must be in the port: at the
same module relative to `imagen_tpu_torch`, or where `MOVED` says. For
methods and properties, `hasattr` on the port's class. The dataclass
fields of `Unet`, `Unet3D`, `Imagen` and `ElucidatedImagen` must be
keywords of the port's constructors; `is_video_unet` is a class attribute.

Names that are not ported sit in `NOT_PORTED` with the reason. An entry
there that the port has after all, or that `imagen_tpu` no longer has,
fails, so the list cannot go stale. Type aliases and module constants are
out of scope.
"""
import ast
import importlib
import inspect
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_ROOT = REPO / 'imagen_tpu'

# a JAX name -> where the port keeps it: relative to imagen_tpu_torch, or an
# absolute module path (torch's); a module's entry moves each of its names
MOVED = {
    'cli.exists': 'utils.helpers.exists',
    'data.Subset': 'torch.utils.data.Subset',
    'ops.temporal_layout.available': 'ops.temporal_layout.temporal_layout_available',
    'utils.orbax_ckpt': 'utils.sharded_ckpt',
}

NOT_PORTED = {
    'parallel.kernel_sharding': (
        'each rank launches its kernels on its own rows, which forward hooks check '
        'on the card; torch has no shard_map to wrap a kernel in'),
    'trainer.ImagenTrainer.abstract_sharded_state': (
        "torch has no ahead-of-time compile of the step to feed an abstract state to"),
    'trainer.ImagenTrainer.state_bundle': (
        "flax's parameter tree as a bundle; a torch module owns its parameters and "
        '`state_dict` is the bundle'),
    'diffusion.imagen.Imagen.init_params': (
        'initialises flax parameter trees; a torch module builds its own parameters'),
    'diffusion.imagen.Imagen.init_unet_params': (
        'initialises flax parameter trees; a torch module builds its own parameters'),
    'diffusion.elucidated.ElucidatedImagen.init_params': (
        "`Imagen.init_params`, borrowed; a torch module builds its own parameters"),
    'diffusion.elucidated.ElucidatedImagen.init_unet_params': (
        "`Imagen.init_unet_params`, borrowed; a torch module builds its own parameters"),
    'utils.checkpoint_io.to_host': (
        'copies a flax tree to host numpy; the port saves state_dicts (`to_cpu`)'),
    'utils.checkpoint_io.restore_parts': (
        "fills a flax target tree from a msgpack bundle; the port loads state_dicts"),
    'ops.flash_attention.flash_temporal_rows': (
        'the TPU-only rows layout behind IMAGEN_TPU_TEMPORAL_ROWS, a TPU A/B knob; '
        '`temporal_attn_fwd.cu` computes its function'),
    'ops.flash_attention.temporal_rows_available': (
        'the gate of the TPU-only rows layout (IMAGEN_TPU_TEMPORAL_ROWS)'),
    'ops.flash_attention.build_rows_bias': (
        'the bias table of the TPU-only rows layout (IMAGEN_TPU_TEMPORAL_ROWS)'),
    'ops.conv2d.dtype_itemsize': "a jnp helper; a torch dtype has `.itemsize`",
    'cli.main': (
        "a no-op stub of lucidrains' console script; the port's command line is the "
        "`imagen` click group (`python -m imagen_tpu_torch.cli`)"),
}

DATACLASSES = {'Unet': 'models.unet2d', 'Unet3D': 'models.unet3d',
               'Imagen': 'diffusion.imagen', 'ElucidatedImagen': 'diffusion.elucidated'}
CLASS_ATTRIBUTES = {('Unet3D', 'is_video_unet'): True}
FLAX_HOOKS = ('setup',)


def _public(name):
    return not name.startswith('_')


def _module_name(path):
    parts = path.relative_to(JAX_ROOT).with_suffix('').parts
    return '.'.join(p for p in parts if p != '__init__')


def _class_members(node):
    for sub in node.body:
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if _public(sub.name) and sub.name not in FLAX_HOOKS:
                yield sub.name
        elif isinstance(sub, ast.Assign) and isinstance(sub.value, (ast.Name, ast.Attribute)):
            yield from (t.id for t in sub.targets
                        if isinstance(t, ast.Name) and _public(t.id))


def walk_module(path):
    """The public surface of one JAX module: [(qualified name relative to
    imagen_tpu, module, top-level name, member or None)]."""
    module = _module_name(path)
    tree = ast.parse(path.read_text())
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if not _public(node.name):
                continue
            names.append((node.name, None))
            if isinstance(node, ast.ClassDef):
                names += [(node.name, m) for m in _class_members(node)]
        elif isinstance(node, ast.ImportFrom) and path.name == '__init__.py':
            names += [(a.asname or a.name, None) for a in node.names
                      if _public(a.asname or a.name)]
    prefix = f'{module}.' if module else ''
    return [(prefix + top + (f'.{member}' if member else ''), module, top, member)
            for top, member in names]


JAX_MODULES = sorted(JAX_ROOT.rglob('*.py'))
SURFACE = [entry for path in JAX_MODULES for entry in walk_module(path)]


def _import(dotted):
    """The object at a dotted path: the longest importable module prefix,
    then attributes."""
    parts = dotted.split('.')
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module('.'.join(parts[:i]))
        except ModuleNotFoundError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise ModuleNotFoundError(dotted)


def _port_path(relative):
    return relative if relative.startswith('torch.') else \
        'imagen_tpu_torch' + (f'.{relative}' if relative else '')


def port_has(qualified, module, top, member):
    """Whether the port has the JAX name, where it or `MOVED` says."""
    if qualified in MOVED:
        path = _port_path(MOVED[qualified])
    else:
        module = MOVED.get(module, module)
        path = _port_path(f'{module}.{top}' if module else top)
        if member is not None:
            path = f'{path}.{member}'
    try:
        _import(path)
    except (ImportError, AttributeError):
        return False
    return True


def _not_ported_reason(qualified, module):
    return NOT_PORTED.get(qualified, NOT_PORTED.get(module))


@pytest.mark.parametrize('path', JAX_MODULES, ids=lambda p: _module_name(p) or '__init__')
def test_the_port_has_every_public_name_of_the_module(path):
    missing = [q for q, module, top, member in walk_module(path)
               if _not_ported_reason(q, module) is None
               and not port_has(q, module, top, member)]
    assert not missing, f'not in the port and not in NOT_PORTED: {missing}'


def test_not_ported_names_are_jax_names_the_port_lacks():
    """A stale entry fails: one the JAX package does not have, or one the
    port has after all."""
    jax_names = {q for q, *_ in SURFACE} | {m for _, m, _, _ in SURFACE}
    assert set(NOT_PORTED) <= jax_names, sorted(set(NOT_PORTED) - jax_names)
    assert all(isinstance(r, str) and r for r in NOT_PORTED.values())
    ported = [q for q, module, top, member in SURFACE
              if (q in NOT_PORTED or module in NOT_PORTED)
              and port_has(q, module, top, member)]
    assert not ported, f'in NOT_PORTED, yet the port has them: {ported}'


def test_moved_names_exist_where_they_moved():
    jax_names = {q for q, *_ in SURFACE} | {m for _, m, _, _ in SURFACE}
    assert set(MOVED) <= jax_names, sorted(set(MOVED) - jax_names)
    for relative in MOVED.values():
        _import(_port_path(relative))


def _dataclass_fields(name, module):
    tree = ast.parse((JAX_ROOT / (module.replace('.', '/') + '.py')).read_text())
    node = next(n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == name)
    return [s.target.id for s in node.body
            if isinstance(s, ast.AnnAssign) and isinstance(s.target, ast.Name)]


@pytest.mark.parametrize('name', sorted(DATACLASSES))
def test_dataclass_fields_are_constructor_keywords(name):
    module = DATACLASSES[name]
    cls = getattr(importlib.import_module(f'imagen_tpu_torch.{module}'), name)
    params = inspect.signature(cls.__init__).parameters
    fields = [f for f in _dataclass_fields(name, module) if (name, f) not in CLASS_ATTRIBUTES]
    assert fields
    missing = [f for f in fields if f not in params
               or params[f].kind not in (inspect.Parameter.KEYWORD_ONLY,
                                         inspect.Parameter.POSITIONAL_OR_KEYWORD)]
    assert not missing, f'{name} fields the port does not take: {missing}'
    for (klass, attr), value in CLASS_ATTRIBUTES.items():
        if klass == name:
            assert attr in _dataclass_fields(name, module)
            assert vars(cls)[attr] is value and attr not in params
