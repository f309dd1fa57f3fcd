"""Random draws over the global batch, each rank keeping its rows.

Under a data-parallel mesh every rank of the trainer holds its own rows of
the global batch (`data` x the local rows) and the same generator stream.
JAX draws the times, the noise, the crops, the text drop and the dropout
masks of a sharded step over the global batch from one key, so a mesh run
equals a one-device run row for row. The port's counterpart: inside
`global_rows(n, index)` every per-row draw of the training loss asks for
`n` times the rows it needs and keeps slice `index`; the ranks' streams
stay in step, and a step on `n` ranks equals a one-process step on their
rows concatenated in rank order. Draws that are not per row (a scalar coin,
one augmentation level for the batch) are made as they are, alike on every
rank.
"""
from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar

_SPLIT: ContextVar = ContextVar('imagen_tpu_torch_global_rows', default=(1, 0))


@contextmanager
def global_rows(n, index):
    """Within the block, per-row draws are made over `n` times the rows and
    slice `index` of them kept (see the module docstring)."""
    if not 0 <= index < n:
        raise ValueError(f'row slice {index} of {n}')
    token = _SPLIT.set((n, index))
    try:
        yield
    finally:
        _SPLIT.reset(token)


def rows_of(draw, rows, dim=0):
    """`draw(rows)`: a draw with `rows` entries along `dim`, or inside
    `global_rows(n, index)` slice `index` of `draw(n * rows)`. The rows of
    `dim` may be batch-major folds (b * f, ...): the global fold then holds
    each rank's rows in one run."""
    n, index = _SPLIT.get()
    if n == 1:
        return draw(rows)
    return draw(n * rows).narrow(dim, index * rows, rows).contiguous()
