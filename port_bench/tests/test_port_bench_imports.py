"""Nothing the benchmark runs loads JAX or the JAX package, and the reference
loads nothing of the program. Each check imports in a fresh interpreter and
compares the top-level name of every loaded module, whole."""
from __future__ import annotations

import json
import subprocess
import sys

from port_bench import registry

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'optax', 'imagen_tpu'}


def loaded_after(code):
    """The top-level names of the modules loaded after `code` runs."""
    script = code + ('\nimport sys, json\n'
                     'print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))')
    out = subprocess.run([sys.executable, '-c', script], cwd=registry.ROOT, check=True,
                         capture_output=True, text=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_the_program_load_no_jax():
    names = loaded_after(
        'import imagen_tpu_torch\n'
        'from port_bench import run, registry, flops, calibrate, correctness, roofline, trace\n'
        'for cell in registry.benchmark()["workloads"]:\n'
        '    registry.system(registry.traffic(cell["traffic"])["system"])\n'
        'for m in registry.benchmark()["per_layer"]:\n'
        '    registry.metric(m["name"])\n')
    assert 'imagen_tpu_torch' in names
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = loaded_after('from port_bench.reference import ddpm, numerics, train, unet, build\n'
                         'from port_bench import weights\n')
    assert 'torch' in names
    assert not names & (FORBIDDEN | {'imagen_tpu_torch'})
