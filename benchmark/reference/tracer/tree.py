"""Frozen copy of raytracer_project_tpu_torch/core/tree.py (plain
PyTorch parts only), for the benchmark's reference; see
benchmark/reference/__init__.py."""

from __future__ import annotations

import numpy as np

import torch


def tree_map(fn, obj):
    """Apply fn to every tensor / numpy leaf of nested NamedTuples."""
    if obj is None:
        return None
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        return fn(obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(tree_map(fn, x) for x in obj))
    if isinstance(obj, tuple):
        return tuple(tree_map(fn, x) for x in obj)
    return obj


def to_device(obj, device):
    """Every leaf as a tensor on `device` (numpy leaves keep their dtype)."""
    return tree_map(lambda x: torch.as_tensor(x).to(device), obj)


def flatten(obj, prefix: str = "") -> dict:
    """{dotted field path: numpy array} for every array leaf of a table
    (scalar fields, such as a BVH's depth, are left out)."""
    out = {}
    if obj is None or isinstance(obj, (int, float)):
        return out
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        out[prefix] = np.asarray(obj.cpu() if isinstance(obj, torch.Tensor)
                                 else obj)
        return out
    for name, val in zip(obj._fields, obj):
        out.update(flatten(val, f"{prefix}.{name}" if prefix else name))
    return out


def unflatten(cls, d: dict, prefix: str = ""):
    """Rebuild NamedTuple `cls` from a flat dotted-path dict of arrays;
    fields absent from the dict take their NamedTuple default."""
    kw = {}
    for name in cls._fields:
        key = f"{prefix}.{name}" if prefix else name
        if key in d:
            kw[name] = torch.as_tensor(np.array(d[key]))
    return cls(**kw)

