"""Map, move and walk nested dataclasses of tensors."""

from __future__ import annotations

import dataclasses

import torch


def map_tensors(obj, fn):
    """Copy of ``obj`` with ``fn`` applied to every tensor inside (through
    dataclasses, named and plain tuples, lists and dicts). Other leaves,
    such as a ``torch.Generator``, are kept as they are."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: map_tensors(getattr(obj, f.name), fn)
            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(map_tensors(v, fn) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(map_tensors(v, fn) for v in obj)
    if isinstance(obj, dict):
        return {k: map_tensors(v, fn) for k, v in obj.items()}
    return obj


def to_device(obj, device):
    """Copy of ``obj`` with every tensor inside moved to ``device``
    (``map_tensors``)."""
    return map_tensors(obj, lambda t: t.to(device))


def tensors(obj):
    """Every tensor inside ``obj`` (through dataclasses, tuples, lists and
    dicts), in order."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from tensors(getattr(obj, f.name))
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from tensors(v)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from tensors(v)
