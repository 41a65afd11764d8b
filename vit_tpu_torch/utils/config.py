"""Config (de)serialisation helpers (the port's own copy of
``vit_tpu/utils/config.py:24-60``).

Checkpoints store the model config as JSON, derived ``__post_init__``
fields included (``train/checkpoint.py:_config_to_dict``); rebuilding keeps
the init fields and derives the rest again. A dtype is written as its
``str`` ("torch.bfloat16" here, "<class 'jax.numpy.bfloat16'>" from the JAX
package), and either reads back as the torch dtype.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Type, TypeVar

import torch

T = TypeVar("T")

_DTYPE_NAMES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


def _coerce(field: dataclasses.Field, value):
    if value is None:
        return None
    if "dtype" in field.name and isinstance(value, str):
        for name, dt in _DTYPE_NAMES.items():
            if name in value:
                return dt
    if isinstance(value, list):
        return tuple(value)
    return value


def dataclass_from_dict(cls: Type[T], data: dict) -> T:
    """A config dataclass from a dict written by ``_config_to_dict``,
    ignoring derived fields."""
    init_fields = {f.name: f for f in dataclasses.fields(cls) if f.init}
    kwargs = {name: _coerce(f, data[name])
              for name, f in init_fields.items() if name in data}
    return cls(**kwargs)


def str2bool(value) -> bool:
    """argparse boolean: the usual spellings of true and false, nothing
    else (``type=bool`` would read ``--mixed False`` as True)."""
    if isinstance(value, bool):
        return value
    v = str(value).strip().lower()
    if v in ("true", "t", "yes", "y", "1"):
        return True
    if v in ("false", "f", "no", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {value!r}")
