"""Helpers and the JAX weights bridge."""
from imagen_tpu_torch.utils.helpers import (
    exists,
    default,
    identity,
    first,
    maybe,
    once,
    divisible_by,
    cast_tuple,
    compact,
    pad_tuple_to_length,
    safe_get_tuple_index,
    maybe_transform_dict_key,
)
